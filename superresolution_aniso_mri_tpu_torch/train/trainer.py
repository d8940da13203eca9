"""Trainer: experiment directory, epoch bookkeeping, validation,
checkpoints and best-model aliases.

Port of the ``ae`` / ``ae_combined`` + ``VanillaACAI`` part of
``superresolution_aniso_mri_tpu/train/trainer.py::Trainer``. It writes
the JAX package's experiment files under ``output_dir``:

  models/<epoch>.models (after ``epoch_threshold``), ae.models,
  caisr.models, last.models    (``train/checkpoint.py`` layout)
  loss_iters.npz, losses_train.npz, losses_test.npz

``settings.yaml`` is not written yet (ROADMAP S2). Not ported, and
raising: other families and models (item 9), perceptual and SSIM losses
(item 8), EMA weights, ``steps_per_dispatch`` (``train_many``) and
TensorBoard logging (item 7), ``num_devices > 1`` (item 11). Volume
previews and image dumps are absent (item 7).
"""
from __future__ import annotations

import os
from collections import defaultdict
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import AEConfig, VanillaACAI
from .checkpoint import load_checkpoint, save_checkpoint
from .state import create_train_state
from .steps import (FAMILY_OF_MODEL, LossConfig, make_eval_step,
                    make_train_step)

# the JAX package's rehydration defaults (config/settings.py) of the keys
# the port reads
SETTING_DEFAULTS = {
    "use_sigmoid": False,
    "use_batchnorm": False,
    "n_res_block": None,
    "colors": 1,
    "use_laploss": False,
    "use_percept_loss": False,
    "image_mix_loss_func": None,
    "use_extra_latent_loss": False,
    "use_loss_annealing": False,
    "get_masks": False,
    "ex_loss_weight1": 0.001,
    "ae_class": "VanillaACAI",
    "momentum": 0.9,
    "weight_decay": 0.0,
    "epoch_threshold": 100,
    "lr_warmup_steps": 0,
    "compute_dtype": "float32",
    "nclasses": 4,
    "ema_decay": 0.0,
    "stem_pad_parity": False,
}


def apply_setting_defaults(args: Dict[str, Any]) -> Dict[str, Any]:
    for k, v in SETTING_DEFAULTS.items():
        args.setdefault(k, v)
    return args


def loss_config_from_args(args: Dict[str, Any]) -> LossConfig:
    """The JAX package's ``loss_config_from_args`` for the non-alpha
    families (the alpha families raise, ROADMAP item 9)."""
    model_name = args["model"]
    if model_name.startswith("alpha") or args.get("dataset") == "ACDCLBL":
        raise NotImplementedError(
            f"model {model_name!r} on dataset {args.get('dataset')!r}: the "
            f"alpha and multichannel families are not ported yet (ROADMAP "
            f"item 9)")
    mix = args.get("image_mix_loss_func")
    if mix is None:
        mix = "perceptual" if args.get("use_percept_loss") else "mse"
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
    )


def weight_annealing_schedule(epochs: int, weight: float) -> np.ndarray:
    """Reversed sigmoid annealing of the synthesis-loss weight."""
    x = np.linspace(-5, 5, epochs)
    y = 1.0 / (1.0 + np.exp(-x)) * weight
    return y[::-1].copy()


def _unsupported(args: Dict[str, Any]) -> Optional[str]:
    if args.get("ae_class", "VanillaACAI") != "VanillaACAI":
        return f"ae_class {args['ae_class']!r} (ROADMAP item 9)"
    if float(args.get("ema_decay") or 0.0) > 0:
        return "ema_decay > 0 (EMA weights, ROADMAP item 7)"
    if int(args.get("steps_per_dispatch", 1) or 1) > 1:
        return "steps_per_dispatch > 1 (train_many, ROADMAP item 7)"
    if args.get("log_tensorboard"):
        return "log_tensorboard (ROADMAP item 7)"
    if int(args.get("num_devices") or 1) > 1:
        return "num_devices > 1 (ROADMAP item 11)"
    return None


class Trainer:
    """Model, optimizer, steps and loss bookkeeping of one experiment.

    ``device=None`` means the CUDA device (raises without one);
    ``seed`` (default ``args["seed"]``, else 0) seeds the weights through
    ``VanillaACAI.reset_parameters`` on a CPU ``torch.Generator``."""

    def __init__(self, args: Dict[str, Any], device=None,
                 seed: Optional[int] = None):
        self.args = apply_setting_defaults(dict(args))
        why = _unsupported(self.args)
        if why:
            raise NotImplementedError(f"not ported yet: {why}")
        self.device = resolve_device(device)
        self.model_config = AEConfig.from_args(self.args)
        self.loss_config = loss_config_from_args(self.args)
        self.family = self.loss_config.family
        model = VanillaACAI(self.model_config)
        model.reset_parameters(torch.Generator().manual_seed(
            seed if seed is not None else int(self.args.get("seed", 0))))
        cosine_steps = None
        if self.args.get("use_lr_scheduler"):
            lim = self.args.get("lr_iter_max")
            if not lim:
                raise ValueError(
                    "--use_lr_scheduler needs --lr_iter_max (total "
                    "iterations of the cosine anneal)")
            cosine_steps = int(lim)
        self.state = create_train_state(
            model.to(self.device), float(self.args["lr"]),
            float(self.args.get("weight_decay", 0.0)),
            float(self.args.get("momentum", 0.9)), cosine_steps,
            float(self.args.get("max_grad_norm", 0) or 0),
            int(self.args.get("lr_warmup_steps", 0) or 0))
        self.train_step = make_train_step(self.loss_config)
        self.eval_step = make_eval_step(self.loss_config)
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
            self.args.setdefault("dir_models", self.dir_models)

    @property
    def model(self) -> VanillaACAI:
        return self.state.model

    @property
    def iters(self) -> int:
        return self._iters

    def prepare_run(self) -> None:
        """Create ``output_dir/models`` (``settings.yaml``: ROADMAP S2)."""
        os.makedirs(self.dir_models, exist_ok=True)

    def _mix_weight(self) -> float:
        if self.args.get("use_loss_annealing"):
            idx = min(self.epoch, len(self.loss_weights) - 1)
            return float(self.loss_weights[idx])
        return float(self.args.get("ex_loss_weight1", 0.001))

    def train(self, batch: Dict[str, torch.Tensor]):
        """One optimizer step on a device batch; its metrics are kept as
        device tensors until the epoch flush."""
        self._iters += 1
        self.state, metrics = self.train_step(self.state, batch,
                                              self._mix_weight())
        for k, v in metrics.items():
            self.losses[k].append(v)
        return metrics

    def validate(self, batch: Dict[str, torch.Tensor]):
        """Record one validation batch's losses (device tensors)."""
        metrics, _ = self.eval_step(self.model, batch, self._mix_weight())
        for k, v in metrics.items():
            self.losses_test[k].append(v)
        return metrics

    def serving_model(self, device=None):
        """An ``infer.ServingModel`` with a copy of the current weights
        (on the trainer's device unless ``device`` is given)."""
        from ..infer import ServingModel

        sd = {k: v.detach().clone() for k, v in
              self.model.state_dict().items()}
        return ServingModel(self.model_config, sd,
                            device=self.device if device is None else device)

    # ------------------------------------------------------------------
    # checkpoints and loss archives
    # ------------------------------------------------------------------

    def save_models(self, fname: str, epoch: int) -> None:
        save_checkpoint(fname, self.state, epoch)

    def load(self, fname: str) -> None:
        self.state, self.epoch = load_checkpoint(fname, self.state)
        self._restore_history()

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
        for key in ("loss_ae_dist", "loss_ae_dist_extra"):
            hist = self.mean_losses_test.get(key, [])[max(thr + 1, 0):]
            if hist:
                self._best_val[key] = float(np.min(hist))

    def save_best_val_model(self) -> None:
        """``ae.models`` on the lowest mean ``loss_ae_dist``,
        ``caisr.models`` on the lowest mean ``loss_ae_dist_extra``, each
        against the best seen when it was saved."""
        for key, alias in (("loss_ae_dist", "ae.models"),
                           ("loss_ae_dist_extra", "caisr.models")):
            hist = self.mean_losses_test.get(key, [])
            if hist and hist[-1] <= self._best_val.get(key, np.inf):
                self._best_val[key] = hist[-1]
                self.save_models(os.path.join(self.dir_models, alias),
                                 self.epoch + 1)

    def show_loss_on_tensorboard(self, eval_type: str = "train") -> None:
        """Flush the step losses to per-epoch means (float64 on the host),
        one stacked device→host copy per key; no TensorBoard."""
        if eval_type == "train":
            loss_dict, mean_losses = self.losses, self.mean_losses
            self.loss_iters.append(self.iters)
        else:
            loss_dict, mean_losses = self.losses_test, self.mean_losses_test
        for key, values in loss_dict.items():
            if values:
                stacked = torch.stack([torch.as_tensor(v) for v in values])
                mean_losses[key].append(float(np.mean(
                    stacked.cpu().numpy().astype(np.float64))))

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
        self.epoch += 1
