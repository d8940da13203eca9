"""Encoder-backbone perceptual distance, NCHW.

Port of ``superresolution_aniso_mri_tpu/ops/perceptual.py``: the LPIPS
mechanism (reference: lpips/networks_basic.py:19-100) over the
framework's own trained super-resolution encoder instead of VGG16. Both
images go through the frozen encoder, tapping both post-LeakyReLU convs
of every scale and the pre-head conv (``Encoder(...,
return_features=True)``); each tap is unit-normalised over channels,
squared-differenced and spatially averaged to [B, C]; non-negative
per-channel 'lin' weights sum the taps to [B] distances.

The artifact (``weights/perceptual_enc.npz``) bundles the encoder
config (``_CFG_KEYS``, as the JAX package writes them), the flax
encoder variables and the lin weights. ``load_enc_perceptual`` turns the
variables into a frozen state dict of the port's ``Encoder`` on the
device (``models/convert.py::flax_encoder_to_torch``); the distance runs
the encoder in eval mode on it through ``torch.func.functional_call``,
so nothing of the artifact is a trainable parameter or is checkpointed.
The encoder runs with the artifact's config and ``compute_dtype``, not
the training model's, and float32 work runs with TF32 off.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.func import functional_call

from ..device import f32_exact, resolve_device
from ..models import AEConfig
from ..models.acai import Encoder
from ..models.convert import flax_encoder_to_torch
from .lpips import _torch_dtype

_WEIGHTS_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "weights"))
_ENC_NPZ = os.path.join(_WEIGHTS_DIR, "perceptual_enc.npz")

# AEConfig fields persisted in the artifact (enough to rebuild the
# encoder; width/latent_width only fix `scales` — the conv stack itself
# is fully convolutional and runs on any even input size)
_CFG_KEYS = ("width", "latent_width", "depth", "latent", "colors",
             "use_batchnorm", "use_sigmoid", "n_res_block")


def _flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}", out)
    else:
        out[prefix] = np.asarray(tree)


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def save_enc_perceptual(path: str, cfg: AEConfig, enc_variables: Dict,
                        lins: List[np.ndarray],
                        meta: Optional[Dict] = None) -> None:
    """Persist the encoder-perceptual artifact.

    ``enc_variables``: the ENCODER's flax variables dict ({'params': ...}
    and optionally {'batch_stats': ...}) of numpy arrays, i.e. the 'enc'
    subtree of a trained VanillaACAI. ``lins``: per-tap non-negative [C]
    weights.
    """
    payload: Dict[str, np.ndarray] = {}
    _flatten(enc_variables, "v", payload)
    for i, lw in enumerate(lins):
        payload[f"lin_{i}"] = np.asarray(lw, np.float32)
    payload["n_lins"] = np.asarray(len(lins), np.int32)
    cfg_dict = {k: getattr(cfg, k) for k in _CFG_KEYS}
    payload["cfg_json"] = np.frombuffer(
        json.dumps(cfg_dict).encode(), dtype=np.uint8)
    if meta:
        payload["meta_json"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_enc_perceptual(path: str, device=None) -> Dict[str, Any]:
    """Load the artifact onto ``device`` (None: the CUDA device) ->
    {'kind': 'enc', 'cfg': AEConfig, 'variables': {port Encoder state
    dict, frozen}, 'lins': [[C] tensors], 'meta': {...}}."""
    with np.load(path) as data:
        cfg_dict = json.loads(bytes(data["cfg_json"]).decode())
        n = int(data["n_lins"])
        lins = [np.asarray(data[f"lin_{i}"], np.float32)
                for i in range(n)]
        meta = (json.loads(bytes(data["meta_json"]).decode())
                if "meta_json" in data else {})
        flat = {k[2:]: data[k] for k in data.files if k.startswith("v/")}
    variables = _unflatten(flat)
    cfg = AEConfig(**{**cfg_dict,
                      "n_res_block": cfg_dict.get("n_res_block") or None})
    dev = resolve_device(device)
    state = {k: v.to(dev) for k, v in
             flax_encoder_to_torch(variables, cfg).items()}
    return {"kind": "enc", "cfg": cfg, "variables": state,
            "lins": [torch.from_numpy(lw).to(dev) for lw in lins],
            "meta": meta}


def get_enc_perceptual_params(path: Optional[str] = None,
                              device=None) -> Dict[str, Any]:
    """Resolve the shipped artifact (or SR_PERCEPTUAL_ENC / explicit
    path). Raises with a build recipe when absent — unlike the VGG
    fallback chain there is no meaningful degraded mode here."""
    path = (path or os.environ.get("SR_PERCEPTUAL_ENC") or _ENC_NPZ)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"encoder-perceptual weights not found at {path}; build "
            f"them from any trained experiment with "
            f"tools/fit_perceptual_head.py --exper_dir <dir>")
    return load_enc_perceptual(path, device)


def _normalize_tensor(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Unit-normalise over channels; eps inside the sqrt keeps the
    gradient finite at all-zero feature vectors (see ops/lpips.py)."""
    norm = torch.sqrt((x ** 2).sum(dim=1, keepdim=True) + eps * eps)
    return x / (norm + eps)


def _run_encoder(cfg: AEConfig, compute_dtype) -> Encoder:
    """An eval-mode ``Encoder`` of the artifact's architecture running in
    ``compute_dtype``; its own (zero) parameters are never used, the
    artifact's state is passed in at each call."""
    want = str(_torch_dtype(compute_dtype)).replace("torch.", "")
    run_cfg = (cfg if cfg.compute_dtype == want
               else AEConfig(**{**{k: getattr(cfg, k) for k in _CFG_KEYS},
                                "compute_dtype": want}))
    return Encoder(run_cfg).eval().requires_grad_(False)


def _encoder_taps(enc: Encoder, variables: Dict[str, torch.Tensor],
                  x: torch.Tensor) -> List[torch.Tensor]:
    """Frozen-encoder feature taps for one input batch [B, C, H, W]."""
    with f32_exact():
        _, feats = functional_call(enc, variables, (x,),
                                   {"train": False, "return_features": True})
    return feats


def _tap_diffs(enc, variables, in0, in1) -> List[torch.Tensor]:
    """Per tap, the [B, C] spatial means of the squared differences of
    the unit-normalised features."""
    f0 = _encoder_taps(enc, variables, in0)
    f1 = _encoder_taps(enc, variables, in1)
    return [((_normalize_tensor(a.float()) - _normalize_tensor(b.float()))
             ** 2).mean(dim=(2, 3)) for a, b in zip(f0, f1)]


def make_enc_distance(cfg: AEConfig, compute_dtype=torch.float32):
    """Closure over the (static) encoder architecture: returns
    dist(variables, lins, in0, in1) -> [B] float32."""
    enc = _run_encoder(cfg, compute_dtype)

    def dist(variables, lins, in0: torch.Tensor,
             in1: torch.Tensor) -> torch.Tensor:
        val = torch.zeros(in0.shape[0], dtype=torch.float32,
                          device=in0.device)
        with f32_exact():
            for d, lw in zip(_tap_diffs(enc, variables, in0, in1), lins):
                val = val + d @ lw.to(torch.float32)
        return val

    return dist


# (cfg, dtype name) -> distance closure (AEConfig is a frozen dataclass,
# hashable, so it keys the cache directly)
_DIST_CACHE: Dict[Any, Any] = {}


def enc_lpips_distance(params: Dict[str, Any], in0: torch.Tensor,
                       in1: torch.Tensor, normalize: bool = True,
                       compute_dtype=torch.float32) -> torch.Tensor:
    """LPIPS-shaped entry point over the encoder backbone.

    in0/in1: [B, 1, H, W] in [0, 1] — the encoder's native input range
    (``normalize`` is accepted for lpips_distance signature parity but
    is a no-op: unlike VGG there is no [-1,1]/ImageNet remap).
    Returns [B] float32 distances.
    """
    del normalize
    key = (params["cfg"], str(_torch_dtype(compute_dtype)))
    if key not in _DIST_CACHE:
        _DIST_CACHE[key] = make_enc_distance(params["cfg"], compute_dtype)
    return _DIST_CACHE[key](params["variables"], params["lins"], in0, in1)


def enc_perceptual_loss(params: Dict[str, Any], pred: torch.Tensor,
                        target: torch.Tensor) -> torch.Tensor:
    """Scalar mean distance — the training-loss form."""
    return enc_lpips_distance(params, pred, target).mean()


def enc_feature_diff_vectors(params: Dict[str, Any], in0: torch.Tensor,
                             in1: torch.Tensor) -> torch.Tensor:
    """[B, sum_C] concatenated per-channel normalized-feature squared
    diffs (spatially averaged) — the design matrix of the lin-weight
    fit. enc_lpips_distance == concat(lins) . this, by construction."""
    enc = _run_encoder(params["cfg"], torch.float32)
    return torch.cat(_tap_diffs(enc, params["variables"], in0, in1), dim=-1)


def uniform_lins(cfg: AEConfig) -> List[np.ndarray]:
    """Training-free default: every tap contributes its channel mean.
    Taps = BOTH post-LeakyReLU convs per scale + the pre-head conv
    (``Encoder(..., return_features=True)``)."""
    chans = []
    for s in range(cfg.scales):
        chans.extend([cfg.depth << s] * 2)
    chans.append(cfg.depth << cfg.scales)
    return [np.full((c,), 1.0 / c, np.float32) for c in chans]
