"""The gaps that decide ``correct``: each a number compared with its
limit (``limits/<cell>.json``)."""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import torch


def rel_gap(prog: Iterable[float], ref: Iterable[float]) -> float:
    """The largest |prog - ref| / |ref| over paired values."""
    prog, ref = list(prog), list(ref)
    if len(prog) != len(ref):
        return float("inf")
    return max((abs(p - r) / abs(r) for p, r in zip(prog, ref)), default=0.0)


def abs_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest |prog - ref| over two tensors of one shape (inf when
    the shapes differ or a value is not finite where the other is)."""
    if tuple(prog.shape) != tuple(ref.shape):
        return float("inf")
    p, r = prog.double().cpu(), ref.double().cpu()
    if not torch.equal(torch.isfinite(p), torch.isfinite(r)):
        return float("inf")
    fin = torch.isfinite(r)
    if not fin.any():
        return 0.0
    return float((p[fin] - r[fin]).abs().max())


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            leaves.items()}


def leaf_norm_gaps(prog: Dict[str, torch.Tensor],
                   ref: Dict[str, torch.Tensor],
                   names: Optional[Iterable[str]] = None) -> List[float]:
    """Per leaf, the gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and its median
    leaf's norm (inf for every leaf when the program lacks one)."""
    names = list(ref) if names is None else list(names)
    if not names or any(k not in prog for k in names):
        return [float("inf")]
    pn, rn = _norms({k: prog[k] for k in names}), _norms({k: ref[k]
                                                          for k in names})
    med = float(torch.tensor([rn[k] for k in names]).median())
    return [abs(pn[k] - rn[k]) / max(rn[k], med) for k in names]


def leaf_norm_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                  names: Optional[Iterable[str]] = None) -> float:
    """The worst leaf's gap (``leaf_norm_gaps``)."""
    return max(leaf_norm_gaps(prog, ref, names))


def median_leaf_norm_gap(prog: Dict[str, torch.Tensor],
                         ref: Dict[str, torch.Tensor],
                         names: Optional[Iterable[str]] = None) -> float:
    """The median leaf's gap (``leaf_norm_gaps``): steady from seed to
    seed where one small leaf's gap swings."""
    return float(torch.tensor(leaf_norm_gaps(prog, ref, names),
                              dtype=torch.float64).median())


def moving(grad1: Dict[str, torch.Tensor],
           share: float = 1e-3) -> Dict[str, torch.Tensor]:
    """Per leaf, the mask of the entries whose first reference gradient
    is at least ``share`` of the median leaf's root-mean-square gradient.
    The others (a bias whose channel's BatchNorm cancels it, a leaf
    that the loss does not reach) have gradients that are nought to
    rounding, which Adam's normalisation turns into full steps of either
    sign: they are left out of the parameters' change. Leaves with no
    entry left drop out."""
    rms = [float(torch.linalg.vector_norm(g.double())) / g.numel() ** 0.5
           for g in grad1.values()]
    thr = share * float(torch.tensor(rms).median())
    masks = {k: g.abs() >= thr for k, g in grad1.items()}
    return {k: m for k, m in masks.items() if bool(m.any())}
