"""The frozen FLOP counts equal those of the port's measurement tools
(``tools/roofline.py`` through ``train_bench`` and ``infer_roofline``)
at small shapes."""
from __future__ import annotations

import pytest
import torch

from port_bench.counts import flops, peaks
from port_bench.reference.model import Arch


@pytest.mark.parametrize("use_laploss", [True, False])
@pytest.mark.parametrize("width,latent_width,pairs", [(16, 4, 2), (32, 8, 3)])
def test_train_step_flops_match_roofline(width, latent_width, pairs,
                                         use_laploss):
    from superresolution_aniso_mri_tpu_torch.tools import train_bench

    args = train_bench.trainer_args(width, latent_width, 4, 8, pairs,
                                    "float32")
    args["use_laploss"] = use_laploss
    want = train_bench.meta_step_flops(args, width, pairs)
    arch = Arch(width, latent_width, 4, 8)
    assert flops.train_step_flops(arch, pairs, width, use_laploss) == want


@pytest.mark.parametrize("kept,alphas,size", [(5, 3, 16), (4, 5, 24)])
def test_synthesis_flops_match_roofline(kept, alphas, size):
    from superresolution_aniso_mri_tpu_torch.models import AEConfig
    from superresolution_aniso_mri_tpu_torch.tools import infer_roofline

    cfg = AEConfig(width=16, latent_width=4, depth=4, latent=8)
    net, x, a = infer_roofline.volume_case(cfg, kept, size, alphas + 1,
                                           torch.device("meta"))
    want = infer_roofline.volume_flops(net, x, a)
    arch = Arch(16, 4, 4, 8)
    assert flops.synthesis_flops(arch, kept, alphas, size, size,
                                 False) == want


def test_ssim_least_time_is_the_byte_bound_at_volume_sizes():
    f, b = flops.ssim_counts(175, 220, 220)
    assert b / peaks.HBM_BYTES_PER_S > f / peaks.F32_FLOPS
    # the bound the port's table gives the kernel: 67.8 MB at 3.35 TB/s
    assert abs(b / peaks.HBM_BYTES_PER_S * 1e6 - 20.2) < 0.1


def test_ssim_count_takes_the_scored_slices_not_the_padding():
    from port_bench import harness
    from port_bench.tests.small import small_cell

    cell = small_cell("dhcp-findbest-score")
    job = harness.driver("score").Job(cell, 3_000_000_023,
                                      torch.device("cpu"))
    # 9 slices at ds 4 keep 3 and synthesize all 9; the program pads its
    # chunks to more
    ds = cell.config["dataset"]
    n = int(cell.traffic["volumes_per_request"]) * int(ds["slices"])
    f, b = flops.ssim_counts(n, int(ds["inplane"]), int(ds["inplane"]))
    padded = sum(c["hr"].shape[0] * c["hr"].shape[1]
                 for c in job.prep["chunks"])
    assert padded > n
    assert job.work_counts()["ssim_least_s_per_request"] == max(
        f / peaks.F32_FLOPS, b / peaks.HBM_BYTES_PER_S)
