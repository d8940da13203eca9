"""Cells of the manifest cut to a size a CPU test holds: the same
layers, losses, traffic kinds and limits at a few pixels."""
from __future__ import annotations

import copy

from port_bench import harness


def small_cell(name: str, widths: bool = False) -> harness.Cell:
    """``name`` with few slices, volumes and pairs; at a few pixels and
    four channels, or with ``widths`` at the configuration's own widths
    and slice sizes (where the card's TF32 paths engage)."""
    cell = copy.deepcopy(harness.load_cell(name))
    cfg, tr = cell.config, cell.traffic
    cfg["recipe"]["batch_size"] = 4
    cfg["dataset"].update(slices=9, train_patients=2)
    if not widths:
        cfg["model"].update(width=16, latent_width=4, depth=4, latent=8)
        crop = bool(cfg["recipe"].get("aug_patch_size"))
        if crop:
            cfg["recipe"]["aug_patch_size"] = 24
            cfg["augment"]["aug_patch_size"] = 24
        cfg["augment"]["patch_size"] = 16
        cfg["dataset"]["inplane"] = (24 if crop and tr["kind"] == "train"
                                     else 16)
    small = dict(volumes_per_request=2, lr_slices=5, pool_volumes=4,
                 sample_range=4, checked_requests=2, weight_sets=2)
    tr.update({k: v for k, v in small.items() if k in tr})
    return cell
