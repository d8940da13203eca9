"""Command dispatcher of the port:

    python -m superresolution_aniso_mri_tpu_torch.cli <command> [flags]

with the commands of the JAX package's root scripts (same flags):
train-brain, train-cardiac, generate-hr-volumes, serve-hr-volumes,
find-best-model, fit-latent-taps, and the JAX package's tools
convert-reference-checkpoint (a reference torch experiment → SRTPU1),
export-reference-checkpoint (a checkpoint → a reference torch
.models), lpips-gap-study, fit-perceptual-head,
convert-lpips-weights, the quality harnesses real-pipeline-quality
and quality-check, and the measurement commands bench (the root
``bench.py``), infer-roofline, train-bench, pipeline-bench and
loader-bench (``tools/``; on the card unless ``--device cpu``). Exits 0
on success, as the JAX package's console scripts do.

With ``SR_KERNEL_LAUNCHES_LOG`` set to a path, a command appends one
JSON line there when it returns: the command and the launches of each
hand-written kernel it made (``ops/cuda_kernels.py``'s counts), so a
harness can count what its child commands launched.
"""
from __future__ import annotations

import json
import os
import sys

from ..tools import (bench, convert_lpips_weights, fit_perceptual_head,
                     infer_roofline, loader_bench, lpips_gap_study,
                     pipeline_bench, quality_check, real_pipeline_quality,
                     train_bench)
from . import entry

COMMANDS = {
    "train-brain": entry.train_brain,
    "train-cardiac": entry.train_cardiac,
    "generate-hr-volumes": entry.generate_hr_volumes,
    "serve-hr-volumes": entry.serve_hr_volumes,
    "find-best-model": entry.find_best_model,
    "fit-latent-taps": entry.fit_latent_taps,
    "convert-reference-checkpoint": entry.convert_reference_checkpoint,
    "export-reference-checkpoint": entry.export_reference_checkpoint,
    "lpips-gap-study": lpips_gap_study.main,
    "fit-perceptual-head": fit_perceptual_head.main,
    "convert-lpips-weights": convert_lpips_weights.main,
    "real-pipeline-quality": real_pipeline_quality.main,
    "quality-check": quality_check.main,
    "bench": bench.main,
    "infer-roofline": infer_roofline.main,
    "train-bench": train_bench.main,
    "pipeline-bench": pipeline_bench.main,
    "loader-bench": loader_bench.main,
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        print(__doc__.strip(), file=sys.stderr)
        return 2
    COMMANDS[argv[0]](argv[1:])
    log = os.environ.get("SR_KERNEL_LAUNCHES_LOG")
    if log:
        from ..ops.cuda_kernels import LAUNCHES

        with open(log, "a") as f:
            f.write(json.dumps({"command": argv[0],
                                "launches": dict(LAUNCHES)}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
