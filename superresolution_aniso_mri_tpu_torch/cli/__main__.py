"""Command dispatcher of the port:

    python -m superresolution_aniso_mri_tpu_torch.cli <command> [flags]

with the commands of the JAX package's root scripts (same flags):
train-brain, train-cardiac, generate-hr-volumes, serve-hr-volumes,
find-best-model, fit-latent-taps, and the JAX package's tools
convert-reference-checkpoint (a reference torch experiment → SRTPU1)
and export-reference-checkpoint (a checkpoint → a reference torch
.models). Exits 0 on success, as the JAX package's console scripts do.
"""
from __future__ import annotations

import sys

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
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        print(__doc__.strip(), file=sys.stderr)
        return 2
    COMMANDS[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
