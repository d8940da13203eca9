"""Trainer: experiment directory, epoch bookkeeping, validation,
checkpoints and best-model aliases; ``get_trainer`` rebuilds one from an
experiment directory.

Port of ``superresolution_aniso_mri_tpu/train/trainer.py``, for every
``ae_class`` of ``models.MODEL_REGISTRY`` (``-m vae``/``vae_combined``
route to ``VAE``, ``vae2`` to ``VAE2``, ``-d ACDCLBL`` to
``MultiChannelAE`` and the ``multichannel`` / ``multichannel_combined``
families; the ACAI family trains the ``{"ae", "disc"}`` ``ModuleDict``
under a ``PartitionOptimizer``; the alpha families the ``{"ae",
"probe"[, "decoder_mix"]}`` ``ModuleDict`` under one Adam with no weight
decay, the probe of ``--alpha_class`` with 5 features). It writes the
JAX package's experiment files under ``output_dir``:

  settings.yaml                (``config/settings.py``)
  models/<epoch>.models (after ``epoch_threshold``), ae.models,
  caisr.models, last.models    (``train/checkpoint.py`` layout; the
                               multichannel families select
                               caisr.models on ``loss_ae_extra``)
  models/ema.models            (``ema_decay > 0``: the averaged weights)
  loss_iters.npz, losses_train.npz, losses_test.npz
  log_images/                  (``cli/train_loop.py`` writes the PNGs)
  tb/                          (``log_tensorboard``, when tensorboardX
                               imports)

The perceptual losses take frozen weights that the trainer resolves
as JAX does (``lpips_params``: VGG LPIPS for ``perceptual``, the encoder
artifact for ``perceptual_enc``) and records their mode in
``args["lpips_mode"]``, hence in ``settings.yaml``; they are not among
``state.params()``, so the optimizer never sees them. An ``eval_mode``
trainer resolves none of them (it builds no step) and keeps the
``lpips_mode`` of its settings; JAX's resolves them in both modes.

``load_caisr`` loads a second model for the AE+CAISR combo:
``params_sr`` is an eval-mode autoencoder of the primary's class and
config, and ``encode`` / ``decode`` / ``predict(use_sr_model=True)`` and
the synthesis of ``infer.create_super_volume`` go through it.

``train_many`` runs N steps through ``make_multi_train_step`` (a CUDA
graph replayed per step on the card). The step's random draws (ACAI's
critic alphas, the VAE's reparametrisation noise) come from the
trainer's own ``torch.Generator`` on its device, seeded from the seed,
and enter the batch (``draw_noise``).

``num_devices`` N > 1 trains data-parallel (``parallel.mesh``): one
trainer per rank of a process group of N ranks (``parallel.launch``;
the train CLI starts them), each on its rank's device. ``train`` takes
the global batch, the same on every rank, draws its noise for the
global batch and steps on the rank's rows; the step reduces the losses,
the BatchNorm statistics and the gradient over the group, so every
rank holds the single-process state of the global batch. ``validate``
scores the whole batch on every rank. Only rank 0 writes
(``settings.yaml``, checkpoints, loss archives, TensorBoard, EMA), as
JAX gates them. As in JAX: ``steps_per_dispatch > 1`` with N > 1
raises ValueError (the CUDA-graph replay stays single-device), and so
does N beyond the attached devices (outside a group) or a global batch
whose pair count N does not divide. A trainer with N > 1 builds outside
a group; its ``train`` then raises. A training trainer whose
``ae_class`` cannot feed its family's loss (``MultiChannelAE``'s
``{"image", "soft_probs"}`` outside the multichannel families, or
another class in them) raises a ValueError; JAX builds it and fails at
its first step. An ``eval_mode`` trainer (serving, scoring) builds no
train or eval step, so the training-only options of the experiment do
not matter.
"""
from __future__ import annotations

import copy
import os
import warnings
from collections import defaultdict
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config.settings import (apply_setting_defaults, load_settings,
                               save_experiment_settings)
from ..device import f32_exact, resolve_device
from ..models import (AEConfig, AlphaDecoder, Discriminator, build_model,
                      flax_to_torch, make_alpha_probe, reset_parameters)
from ..models.alpha import ALPHA_FEATURES
from ..models.convert import torch_to_flax
from ..ops.lpips import get_lpips_params, lpips_weights_info
from ..ops.perceptual import get_enc_perceptual_params
from ..parallel import (create_mesh, is_main_process, local_mesh,
                        make_sharded_train_step, process_count,
                        process_index, replicate_state)
from ..parallel.distributed import is_rank
from ..utils.profiling import span
from .checkpoint import load_checkpoint, load_checkpoint_raw, save_checkpoint
from .import_torch import (is_torch_checkpoint, load_reference_pickle,
                           reference_state_to_port)
from .state import PartitionOptimizer, create_train_state, make_optimizer
from .steps import (FAMILY_OF_MODEL, LossConfig, make_eval_step,
                    make_multi_train_step, make_train_step)


# the probe class of an alpha experiment without --alpha_class
DEFAULT_ALPHA_CLASS = "AlphaProbe16v1"


def alpha_mix_scheme(alpha_class: str) -> str:
    """The mixing scheme of a probe class (``steps.alpha_mix``): a
    property of the class, since coefficient counts can coincide."""
    if alpha_class in ("AlphaProbe", "AlphaProbev2"):
        return "pair"
    if alpha_class == "AlphaProbe16Convex":
        return "convex"
    if alpha_class in ("AlphaProbe16v1", "AlphaProbe16v2",
                       "AlphaProbe16ExBN"):
        return "halves"
    if alpha_class.startswith("AlphaProbe256"):
        return "spatial"
    raise ValueError(f"unknown alpha_class {alpha_class!r}")


def alpha_num_coefficients(alpha_class: str, latent: int,
                           latent_width: int) -> int:
    """The number of coefficients a probe class predicts."""
    return {"pair": 2, "convex": latent, "halves": 2 * latent,
            "spatial": latent_width * latent_width}[
                alpha_mix_scheme(alpha_class)]


def loss_config_from_args(args: Dict[str, Any]) -> LossConfig:
    """The JAX package's ``loss_config_from_args``: ``-d ACDCLBL`` trains
    ``multichannel_combined`` when the model flag is a combined one, else
    ``multichannel`` (not the alpha families, which keep their flag);
    the alpha families' synthesis loss is ``alpha_loss_func`` and their
    probe ``alpha_class`` (default ``DEFAULT_ALPHA_CLASS``)."""
    model_name = args["model"]
    if args.get("dataset") == "ACDCLBL" and not model_name.startswith(
            "alpha"):
        model_name = ("multichannel_combined" if "combined" in model_name
                      else "multichannel")

    def mix_fallback(key: str) -> str:
        fn = args.get(key)
        if fn is None:
            fn = "perceptual" if args.get("use_percept_loss") else "mse"
        return fn

    if model_name.startswith("alpha"):
        alpha_class = args.get("alpha_class") or DEFAULT_ALPHA_CLASS
        return LossConfig(
            model=model_name,
            recon_loss="perceptual" if args.get("use_percept_loss") else "mse",
            use_laploss=bool(args.get("use_laploss", False)),
            image_mix_loss_func=mix_fallback("alpha_loss_func"),
            use_masks=bool(args.get("get_masks", False)),
            num_alphas=alpha_num_coefficients(
                alpha_class, int(args["latent"]), int(args["latent_width"])),
            alpha_scheme=alpha_mix_scheme(alpha_class),
            latent=int(args["latent"]),
            lpips_dtype=str(args.get("compute_dtype") or "float32"),
        )
    mix = mix_fallback("image_mix_loss_func")
    tli = str(args.get("train_latent_interp") or "linear")
    if tli != "linear" and FAMILY_OF_MODEL.get(model_name) not in (
            "ae", "ae_combined"):
        raise ValueError(
            f"--train_latent_interp {tli!r} is only supported for the "
            f"ae/ae_combined families (got model={model_name!r})")
    return LossConfig(
        model=model_name,
        recon_loss="perceptual" if args.get("use_percept_loss") else "mse",
        use_laploss=bool(args.get("use_laploss", False)),
        use_ssim_loss=bool(args.get("use_ssim_loss", False)),
        image_mix_loss_func=mix,
        use_extra_latent_loss=bool(args.get("use_extra_latent_loss", False)),
        use_masks=bool(args.get("get_masks", False)),
        train_latent_interp=tli,
        vae_beta=float(args.get("vae_beta") or 0.0),
        # an explicit lamb=0 (recon-term ablation) must survive
        lamb=(1.0 if args.get("lamb") is None else float(args["lamb"])),
        lamb_reg_acai=float(args.get("lamb_reg_acai", 0.5)),
        nclasses=int(args.get("nclasses", 4)),
        # bf16 model compute carries the LPIPS VGG stack with it
        lpips_dtype=str(args.get("compute_dtype") or "float32"),
    )


def weight_annealing_schedule(epochs: int, weight: float) -> np.ndarray:
    """Reversed sigmoid annealing of the synthesis-loss weight."""
    x = np.linspace(-5, 5, epochs)
    y = 1.0 / (1.0 + np.exp(-x)) * weight
    return y[::-1].copy()


def check_data_parallel(args: Dict[str, Any], device,
                        eval_mode: bool = False) -> Optional[list]:
    """The mesh of a data-parallel training run (``num_devices`` N > 1),
    None for one device or ``eval_mode``. Raises JAX's ValueErrors:
    ``steps_per_dispatch > 1`` with N > 1 (in either mode, as JAX); when
    training, a process group whose size is not N or, outside a group,
    fewer than N devices of ``device``'s type attached."""
    n_dev = int(args.get("num_devices") or 1)
    if n_dev <= 1:
        return None
    if int(args.get("steps_per_dispatch", 1) or 1) > 1:
        # fail at construction, not at the first train_many call
        raise ValueError("steps_per_dispatch > 1 is not supported with "
                         "num_devices > 1")
    if eval_mode:
        return None
    if is_rank():
        if process_count() != n_dev:
            raise ValueError(f"--num_devices {n_dev} but the process group "
                             f"has {process_count()} rank(s)")
        return create_mesh()
    return local_mesh(n_dev, device)


def _check_family_model(family: str, ae_class: str) -> None:
    """Raise ValueError unless ``ae_class`` can feed ``family``'s loss:
    the multichannel families train ``MultiChannelAE`` (its decode is
    ``{"image", "soft_probs"}``) and no other family does."""
    labeled = family.startswith("multichannel")
    if labeled != (ae_class == "MultiChannelAE"):
        raise ValueError(
            f"family {family!r} cannot train ae_class {ae_class!r}: the "
            f"multichannel families (dataset ACDCLBL) train MultiChannelAE, "
            f"whose decode returns image and class probabilities, and no "
            f"other family does")


def routed_ae_class(args: Dict[str, Any]) -> str:
    """The model class of an experiment, routed as JAX routes it:
    ``vae``/``vae_combined`` → VAE and ``vae2`` → VAE2 when ``ae_class``
    is the default, ACDCLBL (not the alpha families) → MultiChannelAE."""
    ae_class = args.get("ae_class") or "VanillaACAI"
    flag = args.get("model", "ae")
    if flag in ("vae", "vae_combined") and ae_class == "VanillaACAI":
        ae_class = "VAE"
    elif flag == "vae2" and ae_class == "VanillaACAI":
        ae_class = "VAE2"
    if args.get("dataset") == "ACDCLBL" and not flag.startswith("alpha"):
        ae_class = "MultiChannelAE"
    return ae_class


class Trainer:
    """Model, optimizer, steps and loss bookkeeping of one experiment.

    ``device=None`` means the CUDA device (raises without one);
    ``seed`` (default ``args["seed"]``, else 0) seeds the weights through
    ``models.reset_parameters`` on a CPU ``torch.Generator`` (the Dense
    heads on the device, from one draw of it) and the step noise through
    a generator on the device. ``eval_mode=True`` (serving and scoring)
    builds no train or eval step. The serving surface of
    ``infer.create_super_volume(s)`` (``model_config``, ``device``,
    ``_ae_model()``, ``_ae_params()``, ``params_sr``, ``synth_cache``)
    is the one of ``ServingModel``."""

    params_sr = None
    tb_writer = None

    def __init__(self, args: Dict[str, Any], eval_mode: bool = False,
                 device=None, seed: Optional[int] = None):
        self.args = apply_setting_defaults(dict(args))
        self.eval_mode = eval_mode
        self.device = resolve_device(device)
        # data-parallel training: this rank's replica lives on its device
        self.mesh = check_data_parallel(self.args, self.device, eval_mode)
        if self.mesh is not None and is_rank():
            self.device = self.mesh[process_index()]
        self.model_config = AEConfig.from_args(self.args)
        self.loss_config = loss_config_from_args(self.args)
        self.family = self.loss_config.family
        lc = self.loss_config
        # the loss's frozen weights: an eval-mode trainer builds no step,
        # so it resolves none and keeps the experiment's lpips_mode
        self.lpips_params = None
        losses = (lc.recon_loss, lc.image_mix_loss_func)
        if not eval_mode:
            if "perceptual_enc" in losses:
                self.lpips_params = get_enc_perceptual_params(
                    device=self.device)
                self.args["lpips_mode"] = "encoder_backbone"
            elif "perceptual" in losses:
                self.lpips_params = get_lpips_params(device=self.device)
            if "perceptual" in losses:
                # which LPIPS weights engaged, so settings.yaml carries it
                self.args["lpips_mode"] = lpips_weights_info()["mode"]
        self.args["ae_class"] = routed_ae_class(self.args)
        if not eval_mode:
            _check_family_model(self.family, self.args["ae_class"])
        seed = seed if seed is not None else int(self.args.get("seed", 0))
        # built on the device: a recipe VAE head is 4 GiB
        with torch.device(self.device):
            model = build_model(self.args["ae_class"], self.model_config)
            if self.family == "acai":
                model = torch.nn.ModuleDict(
                    {"ae": model, "disc": Discriminator(self.model_config)})
            elif self.family == "alpha":
                model = torch.nn.ModuleDict({"ae": model, "probe": (
                    make_alpha_probe(
                        self.args.get("alpha_class") or DEFAULT_ALPHA_CLASS,
                        self.model_config, additional_dims=ALPHA_FEATURES,
                        use_batchnorm=bool(self.args.get(
                            "use_batchnorm_probe", False))))})
                if self.args["model"] == "alpha_combined":
                    model["decoder_mix"] = AlphaDecoder(self.model_config)
        reset_parameters(model, torch.Generator().manual_seed(seed))
        self.noise_generator = torch.Generator(
            device=self.device).manual_seed(seed)
        cosine_steps = None
        if self.args.get("use_lr_scheduler"):
            lim = self.args.get("lr_iter_max")
            if not lim:
                raise ValueError(
                    "--use_lr_scheduler needs --lr_iter_max (total "
                    "iterations of the cosine anneal)")
            cosine_steps = int(lim)
        lr = float(self.args["lr"])
        # the alpha families' one Adam over every group has no decay
        wd = (0.0 if self.family == "alpha"
              else float(self.args.get("weight_decay", 0.0)))
        clip = float(self.args.get("max_grad_norm", 0) or 0)
        ae_tx = make_optimizer(lr, wd, float(self.args.get("momentum", 0.9)),
                               cosine_steps, clip,
                               int(self.args.get("lr_warmup_steps", 0) or 0))
        # the critic's Adam keeps betas (0.9, 0.999) and a constant lr
        tx = (PartitionOptimizer({"ae": ae_tx, "disc": make_optimizer(
            lr, wd, 0.9, None, clip)}) if self.family == "acai" else ae_tx)
        self.state = create_train_state(model, lr, tx=tx)
        if self.mesh is not None:
            self.train_step = make_sharded_train_step(
                self.loss_config, self.lpips_params, self.mesh)
            self.state = replicate_state(self.mesh, self.state)
        elif not eval_mode:
            self.train_step = make_train_step(self.loss_config,
                                              self.lpips_params)
        if not eval_mode:
            self.eval_step = make_eval_step(self.loss_config,
                                            self.lpips_params)
        self._multi_step = None
        # EMA (Polyak-averaged) weights with --ema_decay > 0: folded in
        # after every dispatch, written as the rolling models/ema.models;
        # a COPY of the parameters, which the steps update in place
        self.ema_decay = float(self.args.get("ema_decay") or 0.0)
        self.ema_params = (
            {k: p.detach().clone() for k, p in self.state.params().items()}
            if self.ema_decay > 0 and not eval_mode else None)
        # synthesis cores and sweep evaluators built for this model
        self.synth_cache: dict = {}
        self.test_predictions = None
        self._best_val: Dict[str, float] = {}
        self.losses = defaultdict(list)
        self.losses_test = defaultdict(list)
        self.mean_losses = defaultdict(list)
        self.mean_losses_test = defaultdict(list)
        self.loss_iters: list = []
        self._iters = 1
        self.epoch = 0
        self.loss_weights = weight_annealing_schedule(
            int(self.args.get("epochs", 1) or 1),
            float(self.args.get("ex_loss_weight1", 0.001)))
        if self.args.get("output_dir"):
            self.dir_models = os.path.join(self.args["output_dir"], "models")
            self.dir_images = os.path.join(self.args["output_dir"],
                                           "log_images")
            self.args.setdefault("dir_models", self.dir_models)
            self.args.setdefault("dir_images", self.dir_images)

    @property
    def model(self) -> torch.nn.Module:
        return self.state.model

    @property
    def iters(self) -> int:
        return self._iters

    def prepare_run(self) -> None:
        """Create the experiment tree (``models/``, ``log_images/``) and
        write ``settings.yaml``: the trainer's args without the keys that
        start with ``_``. Rank 0 only: ranks share the experiment."""
        if not is_main_process():
            return
        out = self.args["output_dir"]
        os.makedirs(self.dir_models, exist_ok=True)
        os.makedirs(self.dir_images, exist_ok=True)
        save_experiment_settings(
            {k: v for k, v in self.args.items() if not k.startswith("_")},
            os.path.join(out, "settings.yaml"))
        if self.args.get("log_tensorboard"):
            # JAX's contract: tensorboardX when it imports, else no log
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                return
            self.tb_writer = SummaryWriter(logdir=os.path.join(out, "tb"))

    def _mix_weight(self) -> float:
        if self.args.get("use_loss_annealing"):
            idx = min(self.epoch, len(self.loss_weights) - 1)
            return float(self.loss_weights[idx])
        return float(self.args.get("ex_loss_weight1", 0.001))

    def draw_noise(self, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """``batch`` with the step's random draws of its family from the
        trainer's generator: ACAI's ``noise_alpha`` ~ U[0, 0.5) [B], the
        VAE's ``noise_eps`` ~ N(0, 1) [2B, heads' width]; the batch
        itself for the other families. Data-parallel ranks draw for the
        global batch, which they all hold."""
        b = batch["slice_between"].shape[0]
        kw = dict(generator=self.noise_generator, device=self.device)
        if self.family == "acai":
            with span("train.noise", values=b):
                return {**batch, "noise_alpha": torch.rand(b, **kw) / 2.0}
        if self.family == "vae":
            width = self._ae_model().encoder_mu.weight.shape[0]
            with span("train.noise", values=2 * b * width):
                return {**batch,
                        "noise_eps": torch.randn(2 * b, width, **kw)}
        return batch

    def train(self, batch: Dict[str, torch.Tensor]):
        """One optimizer step on a device batch; its metrics are kept as
        device tensors until the epoch flush."""
        self._iters += 1
        self.state, metrics = self.train_step(
            self.state, self.draw_noise(batch), self._mix_weight())
        self._ema_step(1)
        for k, v in metrics.items():
            self.losses[k].append(v)
        return metrics

    def train_many(self, batches):
        """N optimizer steps, one on each device batch of the sequence
        ``batches``, through ``make_multi_train_step`` (on the card a
        CUDA graph replayed per step); the same trajectory as N
        ``train`` calls. Returns the metrics stacked per key ([N])."""
        if self.mesh is not None:
            raise ValueError("steps_per_dispatch > 1 is not supported with "
                             "num_devices > 1 (the sharded step already "
                             "amortizes dispatch across the mesh)")
        if self._multi_step is None:
            self._multi_step = make_multi_train_step(
                self.loss_config, self.lpips_params, device=self.device)
        n = len(batches)
        with span("train.dispatch", steps=n):
            self._iters += n
            self.state, metrics = self._multi_step(
                self.state, [self.draw_noise(b) for b in batches],
                self._mix_weight())
            self._ema_step(n)
            for k, v in metrics.items():
                self.losses[k].extend(v.unbind())
            return metrics

    @torch.no_grad()
    def _ema_step(self, n_steps: int) -> None:
        """Fold the parameters into the EMA with the decay ``ema_decay **
        n_steps``: ``train_many`` keeps no intermediate iterates, so JAX
        compounds the decay over a dispatch, and so does the port."""
        if self.ema_params is None:
            return
        with span("train.ema"):
            d = np.float32(self.ema_decay ** int(n_steps))
            ema = list(self.ema_params.values())
            params = self.state.params()
            torch._foreach_mul_(ema, float(d))
            torch._foreach_add_(ema, torch._foreach_mul(
                [params[k].detach() for k in self.ema_params],
                float(np.float32(1) - d)))

    def validate(self, batch: Dict[str, torch.Tensor]):
        """Record one validation batch's losses (device tensors); its
        predictions stay in ``test_predictions`` for the image dumps."""
        metrics, aux = self.eval_step(self.model, batch, self._mix_weight())
        for k, v in metrics.items():
            self.losses_test[k].append(v)
        self.test_predictions = aux
        return metrics

    def _ae_model(self) -> torch.nn.Module:
        """The autoencoder (the ACAI and alpha families' ``ae``)."""
        model = self.model
        return model["ae"] if isinstance(model, torch.nn.ModuleDict) else model

    def _ae_params(self):
        """(parameters, buffers) of the autoencoder, as ``ServingModel``'s."""
        ae = self._ae_model()
        return dict(ae.named_parameters()), dict(ae.named_buffers())

    def load_caisr(self, fname: str) -> None:
        """Load a second model's weights for SR synthesis (the AE+CAISR
        combo) from ``fname``: an ``SRTPU1`` checkpoint of either
        package (a family checkpoint's ``{"ae", ...}`` tree gives its
        ``ae``) or a reference torch pickle, whose layers without an
        importer keep the primary's values, as in JAX. ``params_sr``
        becomes an eval-mode copy of the autoencoder on the trainer's
        device; the synthesis cores built for an earlier SR model are
        dropped."""
        sr = copy.deepcopy(self._ae_model()).eval().requires_grad_(False)
        if is_torch_checkpoint(fname):
            self._warn_torch_stem_geometry(fname)
            raw = load_reference_pickle(fname)
            sd = {**sr.state_dict(),
                  **reference_state_to_port(raw["model_dict_ae"], sr)}
        else:
            raw = load_checkpoint_raw(fname)
            sd = flax_to_torch(raw["model_dict_ae"],
                               raw.get("batch_stats", {}),
                               self.model_config, sr, device=self.device)
        sr.load_state_dict(sd)
        old = self.params_sr
        if old is not None:
            for key in [k for k in self.synth_cache if k[0] is old]:
                del self.synth_cache[key]
        self.params_sr = sr

    def _serving_ae(self, use_sr_model: bool) -> torch.nn.Module:
        """The SR model when ``use_sr_model`` and one is loaded, else the
        autoencoder (JAX's ``_sr_params``)."""
        if use_sr_model and self.params_sr is not None:
            if not isinstance(self.params_sr, torch.nn.Module):
                raise TypeError(
                    f"params_sr must be the SR model that load_caisr "
                    f"loads (an nn.Module), got "
                    f"{type(self.params_sr).__name__}")
            return self.params_sr
        return self._ae_model()

    @torch.no_grad()
    def encode(self, x, use_sr_model: bool = False) -> torch.Tensor:
        """Eval-mode latents of NCHW images ``x`` (a tensor or array) on
        the trainer's device; ``use_sr_model`` falls back to the
        autoencoder when no SR model is loaded, as in JAX."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        ae = self._serving_ae(use_sr_model)
        with f32_exact():
            if self.family == "vae":
                return ae.encode_mu(x)
            return ae.encode(x)

    @torch.no_grad()
    def decode(self, z, use_sr_model: bool = False):
        """Eval-mode decode of latents ``z`` (MultiChannelAE: its
        ``{"image", "soft_probs"}``)."""
        z = torch.as_tensor(z, dtype=torch.float32, device=self.device)
        with f32_exact():
            return self._serving_ae(use_sr_model).decode(z)

    def predict(self, x, use_sr_model: bool = False):
        return self.decode(self.encode(x, use_sr_model), use_sr_model)

    @torch.no_grad()
    def predict_alpha(self, z_cat, features) -> torch.Tensor:
        """The probe's coefficients (eval mode) for the channel
        concatenation ``z_cat`` [B, 2 * latent, lw, lw] of two latents
        and their features [B, 5]; alpha families only."""
        model = self.model
        if not (isinstance(model, torch.nn.ModuleDict) and "probe" in model):
            raise ValueError("predict_alpha requires an alpha-family model")
        z_cat = torch.as_tensor(z_cat, dtype=torch.float32,
                                device=self.device)
        feats = torch.as_tensor(features, dtype=torch.float32,
                                device=self.device)
        with f32_exact():
            return model["probe"](z_cat, feats)

    @property
    def num_alphas(self) -> int:
        return int(self.loss_config.num_alphas)

    # ------------------------------------------------------------------
    # checkpoints and loss archives
    # ------------------------------------------------------------------

    def save_models(self, fname: str, epoch: int) -> None:
        if is_main_process():  # the ranks' states are equal: rank 0's
            save_checkpoint(fname, self.state, epoch)

    def load(self, fname: str) -> None:
        """Restore ``fname`` (the port's or JAX's ``SRTPU1`` file, or a
        reference torch pickle) into the state; an EMA track resumes from
        ``ema.models`` beside it, else from the loaded weights."""
        self.state, self.epoch = load_checkpoint(fname, self.state)
        if self.mesh is not None:  # every rank resumes rank 0's state
            self.state = replicate_state(self.mesh, self.state)
        self._warn_torch_stem_geometry(fname)
        if self.ema_params is not None:
            ema_path = os.path.join(os.path.dirname(fname), "ema.models")
            source = self.state.params()
            if os.path.isfile(ema_path):
                raw = load_checkpoint_raw(ema_path)
                source = flax_to_torch(raw["model_dict_ae"],
                                       raw.get("batch_stats", {}),
                                       self.model_config, self.model)
            with torch.no_grad():
                for k, v in self.ema_params.items():
                    v.copy_(source[k])
        self._restore_history()

    def _warn_torch_stem_geometry(self, fname: str) -> None:
        if (is_torch_checkpoint(fname)
                and not self.model_config.stem_pad_parity):
            warnings.warn(
                f"{fname}: reference torch checkpoint loaded into the "
                f"shape-exact stem — set stem_pad_parity: true (or "
                f"--stem_pad_parity) to evaluate it through the padded "
                f"stem geometry it was trained with")

    def _restore_history(self) -> None:
        """Reload the loss archives (the first ``epoch`` entries) and the
        best-so-far validation values after a resume."""
        out = self.args.get("output_dir")
        if not out or not os.path.isfile(os.path.join(out,
                                                      "loss_iters.npz")):
            return
        try:
            iters, tr, te = self.load_losses(out)
        except Exception:
            return
        keep = int(self.epoch)
        self.loss_iters = [int(v) for v in iters][:keep]
        for k, v in tr.items():
            self.mean_losses[k] = [float(x) for x in v][:keep]
        for k, v in te.items():
            self.mean_losses_test[k] = [float(x) for x in v][:keep]
        if self.loss_iters:
            self._iters = int(self.loss_iters[-1])
        thr = int(self.args.get("epoch_threshold", 100))
        for key in ("loss_ae_dist", self._caisr_selection_key()):
            hist = self.mean_losses_test.get(key, [])[max(thr + 1, 0):]
            if hist:
                self._best_val[key] = float(np.min(hist))

    def save_best_val_model(self) -> None:
        """``ae.models`` on the lowest mean ``loss_ae_dist``,
        ``caisr.models`` on the lowest mean of ``_caisr_selection_key``,
        each against the best seen when it was saved."""
        for key, alias in (("loss_ae_dist", "ae.models"),
                           (self._caisr_selection_key(), "caisr.models")):
            hist = self.mean_losses_test.get(key, [])
            if hist and hist[-1] <= self._best_val.get(key, np.inf):
                self._best_val[key] = hist[-1]
                self.save_models(os.path.join(self.dir_models, alias),
                                 self.epoch + 1)

    def _caisr_selection_key(self) -> str:
        """The validation metric behind ``caisr.models``: the
        multichannel families' image + label synthesis sum
        ``loss_ae_extra``, the others' ``loss_ae_dist_extra``."""
        return ("loss_ae_extra" if self.family.startswith("multichannel")
                else "loss_ae_dist_extra")

    def show_loss_on_tensorboard(self, eval_type: str = "train") -> None:
        """Flush the step losses to per-epoch means (float64 on the host),
        one stacked device→host copy per key, and write each mean as the
        scalar ``<key>/<eval_type>`` when TensorBoard is on."""
        if eval_type == "train":
            loss_dict, mean_losses = self.losses, self.mean_losses
            self.loss_iters.append(self.iters)
        else:
            loss_dict, mean_losses = self.losses_test, self.mean_losses_test
        for key, values in loss_dict.items():
            if values:
                stacked = torch.stack([torch.as_tensor(v) for v in values])
                mean = float(np.mean(stacked.cpu().numpy().astype(np.float64)))
                mean_losses[key].append(mean)
                if self.tb_writer is not None:
                    self.tb_writer.add_scalar(f"{key}/{eval_type}", mean,
                                              self.iters)

    def reset_losses(self) -> None:
        for d in (self.losses, self.losses_test):
            for key in d:
                d[key] = []

    @staticmethod
    def _savez_atomic(path: str, **arrays) -> None:
        tmp = path + ".tmp.npz"   # np.savez keeps a '.npz' suffix as is
        np.savez(tmp, **arrays)
        os.replace(tmp, path)

    def save_losses(self) -> None:
        if not is_main_process():
            return
        out = self.args["output_dir"]
        self._savez_atomic(os.path.join(out, "loss_iters.npz"),
                           loss_iters=np.array(self.loss_iters))
        self._savez_atomic(
            os.path.join(out, "losses_train.npz"),
            **{k: np.array(v) for k, v in self.mean_losses.items()})
        self._savez_atomic(
            os.path.join(out, "losses_test.npz"),
            **{k: np.array(v) for k, v in self.mean_losses_test.items()})

    @staticmethod
    def load_losses(path_to_exper: str):
        path_to_exper = os.path.expanduser(path_to_exper)
        iters = np.load(os.path.join(path_to_exper,
                                     "loss_iters.npz"))["loss_iters"]
        tr = np.load(os.path.join(path_to_exper, "losses_train.npz"))
        te = np.load(os.path.join(path_to_exper, "losses_test.npz"))
        return (iters, {k: tr[k] for k in tr.files},
                {k: te[k] for k in te.files})

    def end_epoch_processing(self) -> None:
        """Loss archives first, then (after ``epoch_threshold``) the best
        aliases and ``models/<epoch>.models``, then ``last.models``; the
        stored epoch is the next one to run."""
        self.save_losses()
        if self.epoch > int(self.args.get("epoch_threshold", 100)):
            self.save_best_val_model()
            self.save_models(os.path.join(self.dir_models,
                                          f"{self.epoch}.models"),
                             self.epoch + 1)
        self.save_models(os.path.join(self.dir_models, "last.models"),
                         self.epoch + 1)
        if self.ema_params is not None and is_main_process():
            # a normal checkpoint whose parameters are the averaged ones
            # (buffers and optimizer state from the live state): load it
            # with get_trainer(model_nbr='ema')
            save_checkpoint(os.path.join(self.dir_models, "ema.models"),
                            self.state, self.epoch + 1,
                            params=self.ema_params)
        self.epoch += 1

    # ------------------------------------------------------------------
    # TensorBoard images and histograms
    # ------------------------------------------------------------------

    def log_tb_image(self, tag: str, grid_hw: np.ndarray) -> None:
        """Log an [H, W] (or [H, W, C]) image grid, clipped to [0, 1]."""
        if self.tb_writer is None:
            return
        img = np.asarray(grid_hw, np.float32)
        img = img[None] if img.ndim == 2 else np.transpose(img, (2, 0, 1))
        self.tb_writer.add_image(tag, np.clip(img, 0.0, 1.0), self.iters)

    def log_tb_histograms(self) -> None:
        """One histogram per parameter, under JAX's names and layouts
        (the flax tree's path, e.g. ``enc/Conv_0/kernel``, in its
        order)."""
        if self.tb_writer is None:
            return
        params, _ = torch_to_flax(self.state.params())

        def walk(tree, path):
            for key in sorted(tree):
                if isinstance(tree[key], dict):
                    yield from walk(tree[key], path + [key])
                else:
                    yield "/".join(path + [key]), tree[key]

        for name, leaf in walk(params, []):
            self.tb_writer.add_histogram(name, leaf.ravel(), self.iters)


def get_trainer(src_path: str, model_nbr=None, eval_mode: bool = True,
                device=None) -> Trainer:
    """A Trainer rebuilt from an experiment directory's settings.yaml,
    with ``models/<model_nbr>.models`` loaded when ``model_nbr`` is not
    None (an epoch number, 'ae', 'caisr', 'last' or 'ema'). The device is
    ``device`` (None: the CUDA device): a ``device`` key in the settings
    (the JAX package writes ``tpu``) is ignored."""
    settings = load_settings(os.path.join(src_path, "settings.yaml"))
    settings["output_dir"] = src_path
    trainer = Trainer(settings, eval_mode=eval_mode, device=device)
    if model_nbr is not None:
        name = str(model_nbr)
        if not name.endswith(".models"):
            name += ".models"
        trainer.load(os.path.join(src_path, "models", name))
    return trainer
