"""Convert torchvision VGG16 + LPIPS lin weights into the LPIPS npz.

Port of the JAX package's ``tools/convert_lpips_weights.py``: the same
arrays under the same keys, bit for bit, so the output loads in both
packages' ``load_lpips_params`` (and ``get_lpips_params`` resolves it as
mode ``converted``: true LPIPS). The reference's LPIPS stack uses
torchvision's pretrained VGG16 features plus the learned 1x1 'lin'
weights shipped as .pth files (reference: lpips/pretrained_networks.py,
lpips/weights/v0.1/vgg.pth); users supply both files:

    python -m superresolution_aniso_mri_tpu_torch.cli convert-lpips-weights \\
        --vgg16 /path/to/vgg16-397923af.pth \\
        --lin   /path/to/lpips_vgg_v0.1.pth \\
        --out   weights/lpips_vgg.npz

Conversion: torch conv kernels (out, in, kh, kw) → HWIO (kh, kw, in,
out). The 13 VGG16 feature convs sit at torchvision state-dict keys
``features.{0,2,5,7,10,12,14,17,19,21,24,26,28}``; the LPIPS lin
weights at ``lin{0..4}.model.1.weight`` with shape (1, C, 1, 1). The
files are read with ``torch.load(weights_only=True)`` on the CPU; there
is no device work.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

_VGG16_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_LPIPS_CHANNELS = (64, 128, 256, 512, 512)


def convert(vgg16_path: str | None, lin_path: str | None,
            out_path: str) -> None:
    out = {}
    if vgg16_path:
        sd = torch.load(vgg16_path, map_location="cpu", weights_only=True)
        if "state_dict" in sd:
            sd = sd["state_dict"]
        for i, idx in enumerate(_VGG16_CONV_IDX):
            w = sd[f"features.{idx}.weight"].numpy()  # (out, in, kh, kw)
            b = sd[f"features.{idx}.bias"].numpy()
            out[f"conv{i}_kernel"] = np.transpose(w, (2, 3, 1, 0)).astype(
                np.float32)
            out[f"conv{i}_bias"] = b.astype(np.float32)

    if lin_path:
        lin_sd = torch.load(lin_path, map_location="cpu", weights_only=True)
        for k in range(len(_LPIPS_CHANNELS)):
            # keys look like 'lin0.model.1.weight', shape (1, C, 1, 1)
            key = next(kk for kk in lin_sd
                       if kk.startswith(f"lin{k}") and kk.endswith("weight"))
            w = lin_sd[key].numpy()
            out[f"lin{k}_kernel"] = np.transpose(w, (2, 3, 1, 0)).astype(
                np.float32)  # (1, 1, C, 1)
    elif any(k.startswith("conv") for k in out):
        # a full npz with placeholder lins would load as mode
        # 'converted' (true LPIPS) and silently mislabel every metric
        raise SystemExit(
            "--vgg16 without --lin would bake UNLEARNED placeholder lin "
            "weights into a 'converted' archive; pass --lin "
            "(lpips/weights/v0.1/vgg.pth) as well")
    else:
        for k, c in enumerate(_LPIPS_CHANNELS):
            out[f"lin{k}_kernel"] = np.full((1, 1, c, 1), 1.0 / c,
                                            np.float32)

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez(out_path, **out)
    print(f"wrote {out_path} ({len(out)} arrays)")


def main(argv=None) -> None:
    """The ``convert-lpips-weights`` command."""
    p = argparse.ArgumentParser(
        description="Convert torchvision VGG16 + LPIPS lins to the npz")
    p.add_argument("--vgg16", default=None,
                   help="torchvision vgg16 state_dict .pth (omit for a "
                        "lin-only npz, e.g. weights/lpips_lin_vgg.npz)")
    p.add_argument("--lin", default=None,
                   help="LPIPS v0.1 vgg lin weights .pth")
    p.add_argument("--out", default="weights/lpips_vgg.npz")
    a = p.parse_args(argv)
    if not a.vgg16 and not a.lin:
        p.error("need --vgg16 and/or --lin")
    convert(a.vgg16, a.lin, a.out)
