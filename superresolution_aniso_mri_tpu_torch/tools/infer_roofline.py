"""Roofline probe of the volume-synthesis path.

Port of the repo's ``tools/infer_roofline.py`` at ``bench``'s case (the
bench config in bfloat16, 30 kept slices of 220 x 220, ds=6 → 175
output slices), beside the card's name and power limit:

  - FLOPs per volume (``roofline.count_flops``: the convolutions of the
    encode and the decode) and the least bytes per volume (the kept
    slices, the weights and the output volume, each moved once), with
    the compute and bandwidth floors (the time at 100 % of each peak);
  - single-volume sync and amortized latency, with the share of the
    binding floor (JAX's ``MFU`` print, which divides by the compute
    peak; here the binding floor over the time) and of the HBM rate;
  - batched multi-volume throughput (``make_batched_synthesizer``) at
    ``--batches``, and with ``--packed`` the packed decoder
    (``infer/packed_decoder.py``) beside it;
  - ``--split``: the encode, mix and decode stages and the interleave
    timed apart at the batched B=8 shapes (CUDA events), with the
    decode's own FLOPs and share.

``--peak_tflops`` / ``--peak_gbps`` default to the H100's bf16 and HBM
peaks. ``--json_out`` writes the numbers as one JSON object. JAX's
``--depth_sweep`` probes the TPU's (8, 128) lane padding, which the
card has not, and is not ported.

    python -m superresolution_aniso_mri_tpu_torch.cli infer-roofline \\
        [--batches 1 2 4 8] [--packed] [--split] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import numpy as np
import torch

from ..device import f32_exact, resolve_device
from ..infer import ServingModel
from ..infer.super_volume import (SynthesisStages, make_batched_synthesizer,
                                  make_volume_synthesizer)
from ..models import AEConfig, build_model
from . import roofline
from .bench import BENCH_CFG, SEED, to_nchw

NUM_LR_SLICES, HW, DS = 30, 220, 6


def volume_case(cfg: AEConfig, num_lr_slices: int, hw: int, ds: int,
                device: torch.device):
    """(model, kept [K, 1, hw, hw], alphas [ds - 1]) on ``device``: a
    model seeded as ``bench``'s and JAX's ``RandomState(0)`` volume, or
    on the meta device a model and inputs without values (for
    counting)."""
    alphas = torch.from_numpy(
        np.linspace(0, 1, ds + 1)[1:-1].astype(np.float32)).to(device)
    if device.type == "meta":
        with torch.device("meta"):
            net = build_model("VanillaACAI", cfg)
        return net, torch.empty(num_lr_slices, 1, hw, hw,
                                device=device), alphas
    model = ServingModel(cfg, device=device,
                         generator=torch.Generator().manual_seed(SEED))
    volume = np.random.RandomState(SEED).rand(num_lr_slices, hw, hw, 1)
    return model._ae_model(), to_nchw(volume.astype(np.float32),
                                      device), alphas


def volume_flops(net, kept: torch.Tensor, alphas: torch.Tensor) -> int:
    """FLOPs of one served volume: the synthesis core of ``net`` on
    ``kept`` (``use_original=False``, interleaved)."""
    core = make_volume_synthesizer(net)
    return roofline.count_flops(core, kept, alphas, False, True)


def volume_bytes(net, kept: torch.Tensor, ds: int) -> int:
    """Least bytes of one served volume: the kept slices and the weights
    read once, the float32 output volume written once."""
    k, c, h, w = kept.shape
    out = ((k - 1) * ds + 1) * c * h * w * 4
    return roofline.tensor_bytes(kept) + roofline.module_bytes(net) + out


def run(batches=(1, 2, 4, 8),
        peak_tflops: float = roofline.H100_BF16_FLOPS / 1e12,
        peak_gbps: float = roofline.H100_HBM_BYTES_PER_S / 1e9,
        reps: int = 8, split: bool = False,
        packed: bool = False, device=None,
        cfg: Optional[AEConfig] = None, num_lr_slices: int = NUM_LR_SLICES,
        hw: int = HW, ds: int = DS) -> Dict:
    """The probe; prints as it goes and returns the numbers."""
    dev = resolve_device(device)
    cfg = cfg or AEConfig(**BENCH_CFG, compute_dtype="bfloat16")
    info = roofline.card(dev)
    print(f"card: {info['card']}", flush=True)
    net, kept, alphas = volume_case(cfg, num_lr_slices, hw, ds, dev)
    synth = make_volume_synthesizer(net)

    def one():
        return synth(kept, alphas, use_original=False,
                     interleave=True)["volume"]

    flops = volume_flops(net, kept, alphas)
    nbytes = volume_bytes(net, kept, ds)
    floor = roofline.Floor(flops, nbytes, peak_tflops * 1e12,
                           peak_gbps * 1e9)
    print(f"flops/volume: {flops / 1e9:.1f} G")
    print(f"least bytes/volume: {nbytes / 1e9:.3f} GB")
    print(f"compute floor @ {peak_tflops:.0f} TF/s: "
          f"{floor.compute_s * 1e3:.3f} ms")
    print(f"bandwidth floor @ {peak_gbps:.0f} GB/s: "
          f"{floor.bandwidth_s * 1e3:.3f} ms")
    print(f"binding floor: {floor.bound_s * 1e3:.3f} ms "
          f"({floor.bound_by})")

    float(one().sum())
    amort = roofline.amortized_s(one, reps, dev)
    sync = float(np.median(roofline.sync_times(one, reps, dev)))
    out: Dict = {**info, "flops_per_volume": flops,
                 "least_bytes_per_volume": nbytes,
                 "peak_tflops": peak_tflops, "peak_gbps": peak_gbps,
                 "floor_compute_s": floor.compute_s,
                 "floor_bandwidth_s": floor.bandwidth_s,
                 "bound_by": floor.bound_by, "sync_s": sync,
                 "amortized_s": amort, "floor_share": floor.share(amort),
                 "hbm_share": floor.bandwidth_s / amort, "batched": {}}
    print(f"single volume: sync {sync * 1e3:.2f} ms   "
          f"amortized {amort * 1e3:.2f} ms   [{info['card']}]")
    print(f"  share of the binding floor {100 * out['floor_share']:.1f}%   "
          f"HBM share {100 * out['hbm_share']:.2f}%")

    if split:
        out["split"] = _split(net, alphas, num_lr_slices, hw, peak_tflops,
                              peak_gbps, reps, dev, info["card"])

    rng = np.random.RandomState(SEED + 1)
    for b in batches:
        if b <= 1:
            continue
        vols = to_nchw(rng.rand(b, num_lr_slices, hw, hw, 1)
                       .astype(np.float32), dev)
        for pk in ([False, True] if packed else [False]):
            bsynth = make_batched_synthesizer(net, packed=pk)
            float(bsynth(vols, alphas).sum())
            per_vol = roofline.amortized_s(lambda: bsynth(vols, alphas),
                                           reps, dev) / b
            tag = f"B={b}" + (" packed" if pk else "")
            out["batched"][tag] = {"s_per_volume": per_vol,
                                   "floor_share": floor.share(per_vol),
                                   "hbm_share": floor.bandwidth_s / per_vol}
            print(f"batched {tag}: {per_vol * 1e3:6.2f} ms/volume  "
                  f"(share of the binding floor "
                  f"{100 * floor.share(per_vol):.1f}%, HBM "
                  f"{100 * floor.bandwidth_s / per_vol:.2f}%)  "
                  f"[{info['card']}]")
    return out


def _split(net, alphas, k: int, hw: int, peak_tflops: float,
           peak_gbps: float, reps: int, dev: torch.device, card: str
           ) -> Dict:
    """Encode / mix / decode / interleave at B=8, per volume."""
    b = 8
    stages = SynthesisStages(net)
    vols = to_nchw(np.random.RandomState(SEED + 2).rand(b, k, hw, hw, 1)
                   .astype(np.float32), dev)
    with torch.inference_mode(), f32_exact():
        z = stages.encode(vols)
        z_mix = stages.mix(z, alphas, 0, k - 1)
        dec = stages.decode(vols, z, z_mix, False)
        times = {
            "encode": roofline.amortized_s(lambda: stages.encode(vols),
                                           reps, dev),
            "mix": roofline.amortized_s(
                lambda: stages.mix(z, alphas, 0, k - 1), reps, dev),
            "decode": roofline.amortized_s(
                lambda: stages.decode(vols, z, z_mix, False), reps, dev),
            "interleave": roofline.amortized_s(
                lambda: stages.finish(dict(dec), True, False), reps, dev),
        }
        dflops = roofline.count_flops(stages.decode, vols, z, z_mix, False)
    n_dec = k + (k - 1) * alphas.shape[0]
    per_vol = {name: t / b for name, t in times.items()}
    # the decode reads the latents and the weights, writes the slices
    dbytes = (roofline.tensor_bytes(z, z_mix, dec)
              + roofline.module_bytes(net)) / b
    floor = roofline.Floor(dflops / b, dbytes, peak_tflops * 1e12,
                           peak_gbps * 1e9)
    print(f"stage split (B={b}, per volume): "
          + "   ".join(f"{name} {t * 1e3:.2f} ms"
                       for name, t in per_vol.items())
          + f"   [{card}]")
    print(f"  decode alone [{n_dec} slices]: {dflops / b / 1e9:.1f} GF/vol,"
          f" {dbytes / 1e9:.3f} GB/vol least → share of the binding floor "
          f"{100 * floor.share(per_vol['decode']):.1f}%")
    return {**{f"{name}_s_per_volume": t for name, t in per_vol.items()},
            "decode_flops_per_volume": dflops / b,
            "decode_floor_share": floor.share(per_vol["decode"])}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(prog="infer-roofline",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--peak_tflops", type=float,
                    default=roofline.H100_BF16_FLOPS / 1e12,
                    help="bf16 peak TFLOP/s (H100 default)")
    ap.add_argument("--peak_gbps", type=float,
                    default=roofline.H100_HBM_BYTES_PER_S / 1e9,
                    help="HBM peak GB/s (H100 default)")
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--split", action="store_true",
                    help="also time the encode / mix / decode / "
                         "interleave stages separately")
    ap.add_argument("--packed", action="store_true",
                    help="also time the batched path with the packed "
                         "decoder")
    ap.add_argument("--json_out", type=str, default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    out = run(args.batches, args.peak_tflops, args.peak_gbps, args.reps,
              args.split, args.packed, args.device)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.json_out}")
    return out
