"""LPIPS-VGG perceptual distance, NCHW.

Port of ``superresolution_aniso_mri_tpu/ops/lpips.py`` (reference:
lpips/networks_basic.py:19-100 PNetLin, lpips/perceptual.py:6-33):
frozen VGG16 feature slices (relu1_2, relu2_2, relu3_3, relu4_3,
relu5_3) → per-channel unit normalisation → squared difference →
learned 1x1 'lin' weights → spatial mean → sum over the 5 layers.
``normalize=True`` maps [0, 1] inputs to [-1, 1] first; single-channel
inputs broadcast against the 3-channel shift and scale like the
reference's ScalingLayer.

Weights: the numpy part (``init_lpips_params``, the npz readers and the
resolution order of ``get_lpips_params``) is a copy of the JAX
package's, so both packages resolve the same weights, with the same
warnings and errors, and record the same mode (``lpips_weights_info``:
``converted``, ``lin_converted_vgg_random`` or ``random``).
``get_lpips_params`` then converts the tree once to frozen torch tensors
on the device (conv kernels HWIO → OIHW, lin kernels [1, 1, C, 1] →
[1, C, 1, 1]); nothing of it requires a gradient, so it stays out of
autograd's parameter set and out of every checkpoint.

Precision: float32 convolutions run with TF32 off (``f32_exact``), as
the reference runs them at ``Precision.HIGHEST``. ``compute_dtype=
bfloat16`` runs the VGG stack in bfloat16 with the bias added after the
convolution in bfloat16, as the reference does; normalisation and the
distance accumulate in float32 either way.
"""
from __future__ import annotations

import os
import warnings
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import device_constant, f32_exact, resolve_device
from ..models.config import _DTYPES

# VGG16 conv plan: (out_channels per conv, pool before this conv?)
_VGG_PLAN: Sequence[tuple] = (
    (64, False), (64, False),            # slice 1 → relu1_2
    (128, True), (128, False),           # slice 2 → relu2_2
    (256, True), (256, False), (256, False),   # slice 3 → relu3_3
    (512, True), (512, False), (512, False),   # slice 4 → relu4_3
    (512, True), (512, False), (512, False),   # slice 5 → relu5_3
)
# index (into conv list) after which each slice output is taken
_SLICE_ENDS = (1, 3, 6, 9, 12)
LPIPS_CHANNELS = (64, 128, 256, 512, 512)

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def init_lpips_params(seed: int = 0, lin_init: str = "uniform") -> Dict[str, Any]:
    """Deterministic fallback parameters (He-init convs, uniform lin)."""
    rng = np.random.RandomState(seed)
    convs: List[Dict[str, np.ndarray]] = []
    cin = 3
    for cout, _ in _VGG_PLAN:
        fan_in = 3 * 3 * cin
        w = rng.normal(0.0, np.sqrt(2.0 / fan_in), size=(3, 3, cin, cout))
        b = np.zeros((cout,), np.float32)
        convs.append({"kernel": w.astype(np.float32), "bias": b})
        cin = cout
    lins = []
    for c in LPIPS_CHANNELS:
        if lin_init == "uniform":
            lw = np.full((1, 1, c, 1), 1.0 / c, np.float32)
        else:
            lw = np.abs(rng.normal(0.0, 1.0 / c, size=(1, 1, c, 1))).astype(np.float32)
        lins.append({"kernel": lw})
    return {"convs": convs, "lins": lins}


def _convs_lins_from(data) -> Dict[str, Any]:
    """Build the full params tree from an open npz (single source of
    truth for the npz key format)."""
    convs = [{"kernel": data[f"conv{i}_kernel"],
              "bias": data[f"conv{i}_bias"]}
             for i in range(len(_VGG_PLAN))]
    return {"convs": convs, "lins": _lins_from(data)}


def _lins_from(data) -> List[Dict[str, np.ndarray]]:
    return [{"kernel": data[f"lin{i}_kernel"]}
            for i in range(len(LPIPS_CHANNELS))]


def load_lpips_params(path: str) -> Dict[str, Any]:
    """Load full parameters converted by tools/convert_lpips_weights.py."""
    with np.load(path) as data:
        return _convs_lins_from(data)


def load_lin_weights(path: str) -> List[Dict[str, np.ndarray]]:
    """Load only the learned 1x1 'lin' weights (lin{k}_kernel arrays)."""
    with np.load(path) as data:
        return _lins_from(data)


_WEIGHTS_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "weights"))
_FULL_NPZ = os.path.join(_WEIGHTS_DIR, "lpips_vgg.npz")
# learned lin weights converted from the reference's
# lpips/weights/v0.1/vgg.pth (reference: lpips/dist_model.py:19-108)
_LIN_NPZ = os.path.join(_WEIGHTS_DIR, "lpips_lin_vgg.npz")

# info about the most recent get_lpips_params() resolution
_last_info: Dict[str, Any] = {"mode": None, "path": None}


def lpips_weights_info() -> Dict[str, Any]:
    """Mode/path of the last :func:`get_lpips_params` call.

    ``mode`` is one of ``converted`` (full VGG16 + learned lin — true
    LPIPS), ``lin_converted_vgg_random`` (learned lin over deterministic
    random VGG features), or ``random``."""
    return dict(_last_info)


def _warn_lin_fallback() -> None:
    warnings.warn(
        "LPIPS: using learned lin weights over deterministic RANDOM "
        "VGG features (no converted VGG16 backbone found). This is a "
        "usable perceptual signal but NOT true LPIPS; convert "
        "torchvision VGG16 via tools/convert_lpips_weights.py for "
        "exact reference parity.", stacklevel=3)


def get_lpips_params(path: Optional[str] = None, seed: int = 0,
                     device=None) -> Dict[str, Any]:
    """Resolve LPIPS parameters: full converted npz (arg, $LPIPS_WEIGHTS,
    or weights/lpips_vgg.npz) → shipped learned lin weights over random
    VGG features → fully random. Fallbacks warn explicitly; the selected
    mode is queryable via :func:`lpips_weights_info`. The weights land,
    frozen, on ``device`` (None: the CUDA device).

    An explicit ``path`` argument shadows ``$LPIPS_WEIGHTS`` entirely —
    a stale env var must not abort a call that names valid weights."""
    if path and not os.path.isfile(path):
        # an explicitly requested weights file must never silently fall
        # through to a different source
        raise FileNotFoundError(f"LPIPS weights not found: {path}")
    candidates = []
    if path:
        candidates.append(path)
    else:
        env = os.environ.get("LPIPS_WEIGHTS")
        if env:
            if not os.path.isfile(env):
                raise FileNotFoundError(
                    f"LPIPS_WEIGHTS points to a missing file: {env}")
            candidates.append(env)
    candidates.append(_FULL_NPZ)
    for cand in candidates:
        if cand and os.path.isfile(cand):
            with np.load(cand) as data:
                if "conv0_kernel" in data:
                    params = _convs_lins_from(data)
                    _last_info.update(mode="converted", path=cand)
                    return _device(params, device)
                if "lin0_kernel" not in data:
                    raise ValueError(
                        f"{cand}: not an LPIPS weights npz (expected "
                        f"conv0_kernel/... or lin0_kernel/... arrays)")
                # lin-only npz: learned lins over random VGG features
                params = init_lpips_params(seed=seed)
                params["lins"] = _lins_from(data)
            _last_info.update(mode="lin_converted_vgg_random", path=cand)
            _warn_lin_fallback()
            return _device(params, device)
    if os.path.isfile(_LIN_NPZ):
        params = init_lpips_params(seed=seed)
        params["lins"] = load_lin_weights(_LIN_NPZ)
        _last_info.update(mode="lin_converted_vgg_random", path=_LIN_NPZ)
        _warn_lin_fallback()
        return _device(params, device)
    _last_info.update(mode="random", path=None)
    warnings.warn(
        "LPIPS: no converted weights found anywhere — falling back to "
        "deterministic random VGG features with uniform lin weights. "
        "Results are NOT LPIPS.", stacklevel=2)
    return _device(init_lpips_params(seed=seed), device)


def _oihw(kernel) -> np.ndarray:
    return np.ascontiguousarray(
        np.transpose(np.asarray(kernel, np.float32), (3, 2, 0, 1)))


def _device(params: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The numpy tree (HWIO kernels) as frozen float32 tensors on the
    device, converted once: conv kernels OIHW, lin kernels [1, C, 1, 1].
    Same structure and keys as the JAX package's tree."""
    dev = resolve_device(device)

    def put(arr):
        return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(dev)

    return {"convs": [{"kernel": put(_oihw(c["kernel"])),
                       "bias": put(c["bias"])} for c in params["convs"]],
            "lins": [{"kernel": put(_oihw(lw["kernel"]))}
                     for lw in params["lins"]]}


def _torch_dtype(compute_dtype) -> torch.dtype:
    if isinstance(compute_dtype, torch.dtype):
        return compute_dtype
    return _DTYPES[str(compute_dtype)]


def _vgg_features(params: Dict[str, Any], x: torch.Tensor,
                  compute_dtype=torch.float32) -> List[torch.Tensor]:
    """The VGG16 conv stack on ``x`` [B, 3, H, W] (already shift/scale
    normalised); returns the 5 slice activations in ``compute_dtype``."""
    dt = _torch_dtype(compute_dtype)
    feats = []
    h = x.to(dt)
    slice_ends = set(_SLICE_ENDS)
    for i, (_, pool_before) in enumerate(_VGG_PLAN):
        if pool_before:
            if h.shape[2] < 2 or h.shape[3] < 2:
                # thin input (e.g. a long-axis resliced view): deeper
                # pools would collapse a dim to 0 and the distance would
                # go NaN — stop and score over the slices that exist
                break
            h = F.max_pool2d(h, 2)
        conv = params["convs"][i]
        h = F.conv2d(h, conv["kernel"].to(dt), padding=1)
        h = F.relu(h + conv["bias"].to(dt).view(1, -1, 1, 1))
        if i in slice_ends:
            feats.append(h)
    return feats


def _normalize_tensor(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Per-pixel unit-normalise over channels (reference: lpips/common.py
    normalize_tensor). eps lives INSIDE the sqrt, so the gradient stays
    finite at an all-zero feature vector (post-ReLU zeros are common on
    black MRI padding)."""
    norm = torch.sqrt((x ** 2).sum(dim=1, keepdim=True) + eps * eps)
    return x / (norm + eps)


def lpips_distance(params: Dict[str, Any], in0: torch.Tensor,
                   in1: torch.Tensor, normalize: bool = True,
                   use_lin: bool = True,
                   compute_dtype=torch.float32) -> torch.Tensor:
    """LPIPS distance per batch element.

    in0/in1: [B, C, H, W] with C in {1, 3}, on the device of ``params``;
    values in [0, 1] when ``normalize=True`` (mapped to [-1, 1]), else
    already in [-1, 1]. ``compute_dtype`` ('float32', 'bfloat16' or a
    torch dtype) selects the VGG stack's precision; normalisation and
    the lin-weighted accumulation run in float32. Returns [B] float32
    distances, differentiable with respect to both inputs."""
    if "convs" not in params:
        # the JAX function refuses a tree that is not VGG parameters
        # (the encoder artifact's 'kind' string is not an array) with a
        # TypeError too
        raise TypeError(
            f"lpips_distance takes the VGG LPIPS parameters of "
            f"get_lpips_params, got a tree with keys {sorted(params)} "
            f"(kind {params.get('kind')!r})")
    if normalize:
        in0 = 2.0 * in0 - 1.0
        in1 = 2.0 * in1 - 1.0
    shift = device_constant(_SHIFT, torch.float32, in0.device).view(1, 3, 1, 1)
    scale = device_constant(_SCALE, torch.float32, in0.device).view(1, 3, 1, 1)
    # a [B, 1, H, W] input is [B, 3, H, W] after this line, exactly the
    # reference ScalingLayer's [1, 3, 1, 1] broadcast
    in0 = (in0 - shift) / scale
    in1 = (in1 - shift) / scale
    with f32_exact():
        feats0 = _vgg_features(params, in0, compute_dtype)
        feats1 = _vgg_features(params, in1, compute_dtype)
        val = torch.zeros(in0.shape[0], dtype=torch.float32,
                          device=in0.device)
        for k in range(len(feats0)):
            f0 = _normalize_tensor(feats0[k].float())
            f1 = _normalize_tensor(feats1[k].float())
            diff = (f0 - f1) ** 2
            if use_lin:
                d = F.conv2d(diff, params["lins"][k]["kernel"])
                val = val + d.mean(dim=(1, 2, 3))
            else:
                val = val + diff.sum(dim=1).mean(dim=(1, 2))
    return val


def lpips_loss(params: Dict[str, Any], pred: torch.Tensor,
               target: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Scalar mean LPIPS — the training-loss form."""
    return lpips_distance(params, pred, target, normalize=normalize).mean()
