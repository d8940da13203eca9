"""Float64 versions of the scoring metrics, and a report of the
README recipe rows' conventional columns in float64, in JAX's float32
and in the port's float32 (the recorded rows are rounded to 5
decimals; where JAX's and the port's fifth decimal differ, the float64
value says which float32 is off).

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_port_float64.py dhcp \
        [--set extra]

``dhcp`` is the noiseless dHCP row (docs/quality_real_r3.jsonl row 34),
``dhcp_noise`` the σ 0.03 one (docs/quality_real_r5.jsonl row 1),
``acdc`` the cardiac rows (r3 row 32, r4 row 4): the tool's trees and
extra volumes, each conventional method's synthesized-slice aggregate
as ``create_hr_images`` forms it (per volume, then the mean).
"""
import argparse
import importlib
import os
import sys
import tempfile

import numpy as np

from superresolution_aniso_mri_tpu_torch.ops import metrics as tm


def ssim64(a, b, win=7):
    """skimage's SSIM per slice in float64 (uniform window, unbiased
    covariance, the VALID map's mean)."""
    from numpy.lib.stride_tricks import sliding_window_view

    f = lambda x: sliding_window_view(x, (win, win), axis=(-2, -1)).mean(
        axis=(-2, -1))
    ux, uy = f(a), f(b)
    cn = win * win / (win * win - 1.0)
    vx, vy = cn * (f(a * a) - ux * ux), cn * (f(b * b) - uy * uy)
    vxy = cn * (f(a * b) - ux * uy)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * ux * uy + c1) * (2 * vxy + c2))
            / ((ux * ux + uy * uy + c1) * (vx + vy + c2))).mean(axis=(-2, -1))


def vif64(ref, dist, sigma_nsq=2.0):
    """The 4-scale pixel-domain VIF of ``ops/metrics.py`` per slice in
    float64 (the same quantisation, centring, banded gaussians and
    guards)."""
    eps = 1e-10
    ref = np.round(np.clip(ref * 255.0, 0, 255))
    dist = np.round(np.clip(dist * 255.0, 0, 255))
    ref = ref - ref.mean(axis=(-2, -1), keepdims=True)
    dist = dist - dist.mean(axis=(-2, -1), keepdims=True)

    def gf(x, sd):
        gh = tm._band_reflect(x.shape[-2], round(sd, 6)).astype(np.float64)
        gw = tm._band_reflect(x.shape[-1], round(sd, 6)).astype(np.float64)
        return gh @ x @ gw.T

    num = np.zeros(ref.shape[:-2])
    den = np.zeros(ref.shape[:-2])
    for scale in range(1, 5):
        sd = (2 ** (4 - scale + 1) + 1) / 5.0
        if scale > 1:
            ref, dist = gf(ref, sd)[..., ::2, ::2], gf(dist, sd)[..., ::2, ::2]
        mu1, mu2 = gf(ref, sd), gf(dist, sd)
        s1 = np.maximum(gf(ref * ref, sd) - mu1 * mu1, 0.0)
        s2 = np.maximum(gf(dist * dist, sd) - mu2 * mu2, 0.0)
        s12 = gf(ref * dist, sd) - mu1 * mu2
        g = s12 / (s1 + eps)
        sv = s2 - g * s12
        small1 = s1 < eps
        g, sv, s1 = (np.where(small1, 0.0, g), np.where(small1, s2, sv),
                     np.where(small1, 0.0, s1))
        small2 = s2 < eps
        g, sv = np.where(small2, 0.0, g), np.where(small2, 0.0, sv)
        neg = g < 0.0
        sv, g = np.where(neg, s2, sv), np.where(neg, 0.0, g)
        sv = np.maximum(sv, eps)
        num += np.log10(1 + g * g * s1 / (sv + sigma_nsq)).sum(axis=(-2, -1))
        den += np.log10(1 + s1 / sigma_nsq).sum(axis=(-2, -1))
    return num / den


def psnr64(ref, dist):
    """skimage's PSNR per slice in float64 (data range 1)."""
    return 10.0 * np.log10(1.0 / ((ref - dist) ** 2).mean(axis=(-2, -1)))


def conventional_pairs(row: str, which: str) -> dict:
    """method → (reference, reconstruction, synthesized-slice mask) of
    every volume ``create_hr_images`` scores for the conventional
    method on ``row``'s test split or extra set."""
    import torch

    from superresolution_aniso_mri_tpu_torch.data.datasets import (
        load_acdc_volumes, load_brain_volumes)
    from superresolution_aniso_mri_tpu_torch.tools import \
        real_pipeline_quality as rpq

    chi = importlib.import_module(
        "superresolution_aniso_mri_tpu_torch.evaluate.create_hr_images")
    ds = 2 if row == "acdc" else 4
    sigma = 0.0 if row == "dhcp" else 0.03
    pairs = {m: [] for m in ("linear", "bspline", "lanczos")}
    method = None
    scored = chi.compute_volume_metrics

    def keep(ref, up, *a, **k):
        ref, up = np.asarray(ref, np.float32), np.asarray(up, np.float32)
        pairs[method].append((ref, up, tm.synth_slice_mask(
            ref.shape[0], ds, k.get("conv_interpol", False))))
        return scored(ref, up, *a, **k)

    chi.compute_volume_metrics = keep
    old_root = os.environ.get("SR_DATA_ROOT")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.environ["SR_DATA_ROOT"] = tmp
            if row == "acdc":
                if which == "test":
                    rpq.make_textured_acdc_tree(tmp, 24, 64, 15, 6,
                                                noise_sigma=sigma)
                    vols = load_acdc_volumes("test")
                else:
                    vols = rpq.make_extra_test_volumes_acdc(
                        10, 64, 15, 6, noise_sigma=sigma)
            elif which == "test":
                rpq.make_textured_dhcp_tree(tmp, ds, 24, 256, 37,
                                            noise_sigma=sigma)
                vols = load_brain_volumes("dHCP", ds, split="test",
                                          include_hr_images=True)
            else:
                vols = rpq.make_extra_test_volumes(
                    ds, 20 if sigma else 6, 256, 37, noise_sigma=sigma)
            for method in pairs:
                chi.create_hr_images(None, vols, downsample_steps=ds,
                                     interpol_method=method,
                                     device=torch.device("cpu"))
    finally:
        chi.compute_volume_metrics = scored
        if old_root is None:
            os.environ.pop("SR_DATA_ROOT", None)
        else:
            os.environ["SR_DATA_ROOT"] = old_root
    return pairs


def main(argv=None):
    import jax.numpy as jnp
    import torch

    from superresolution_aniso_mri_tpu.ops import metrics as jm

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("row", choices=("dhcp", "dhcp_noise", "acdc"))
    ap.add_argument("--set", default="test", choices=("test", "extra"))
    args = ap.parse_args(argv)
    for method, pairs in conventional_pairs(args.row, args.set).items():
        for name, f64, jfn, pfn in (
                ("ssim_synth", ssim64, jm.ssim_volume, tm.ssim_volume),
                ("psnr_synth", psnr64, jm.psnr_volume, tm.psnr_volume),
                ("vif_synth", vif64, jm.vif_volume, tm.vif_volume)):
            vals = np.array([[
                f64(r.astype(np.float64), u.astype(np.float64))[m].mean(),
                np.asarray(jfn(jnp.asarray(r), jnp.asarray(u)))[m].mean(),
                pfn(torch.from_numpy(r), torch.from_numpy(u)).numpy()[
                    m].mean()] for r, u, m in pairs])
            f, j, p = vals.mean(axis=0)
            print(f"{args.row} {args.set} {method:8s} {name:10s} float64 "
                  f"{f:.7f}  JAX f32 {j:.7f} ({j - f:+.1e})  port f32 "
                  f"{p:.7f} ({p - f:+.1e})", flush=True)


if __name__ == "__main__":
    sys.exit(main())
