"""Device-resident slice cache: the padded slice stacks live on the
device, and each batch is one gather.

Port of ``superresolution_aniso_mri_tpu/data/device_cache.py``. The host
path (``TripletSampler``) assembles every batch on the CPU and uploads its
pixels each step (16 × 220² × 3 float32, 9.3 MB, for the README's OASIS
recipe). When the padded stacks fit the budget, ``DeviceCachedSampler``
uploads them once and a batch costs the upload of its slice indices. The
sampler's ``RandomState`` draws stay on the host, in the host path's
order, so the two paths give bitwise the same batches.

``--device_data_cache auto|0|1``: ``auto`` turns the cache on when the
stacks fit the budget: ``SR_DEVICE_CACHE_MB`` when it is set, else a
quarter of the CUDA device's free memory (20 GB on an idle 80 GB card:
the README's OASIS recipe, 200 training patients of 176 x 220² float32,
needs 6.8 GB), else, on the CPU, the JAX package's 512 MB. Labeled
samplers (ACDCLBL) also keep their label stacks, and ``--get_masks``
their loss-mask stacks, on the device; the budget counts them.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ..utils.profiling import span
from .pairs import TripletSampler

DEFAULT_BUDGET_MB = 512.0     # the JAX package's default, kept off the card
CUDA_FREE_SHARE = 0.25        # of the card's free memory, for the cache


class DeviceCachedSampler:
    """A ``TripletSampler`` whose batches carry a ``triplet`` gathered on
    ``device`` ([B, P, P, C] float32, the host layout: image, then label
    per slot, the between slice's loss mask last). Its draws are the
    wrapped sampler's, in the same order."""

    def __init__(self, sampler: TripletSampler, device):
        self.s = sampler
        self.device = torch.device(device)
        counts = [p.shape[0] for p in sampler._padded]
        # flat index base per volume: the specs' slice ids are
        # volume-relative
        self._base = np.concatenate(
            ([0], np.cumsum(counts[:-1]))).astype(np.int64)
        # float32, as the host sampler's batches (the rescaled volumes
        # can be float64)
        self.flat_img = self._upload(sampler._padded)
        self.flat_lbl = (self._upload(sampler._padded_labels)
                         if sampler.has_labels else None)
        self.flat_mask = (self._upload(sampler._padded_masks)
                          if sampler.use_masks else None)

    def _upload(self, stacks) -> torch.Tensor:
        return torch.from_numpy(np.concatenate(stacks, axis=0).astype(
            np.float32, copy=False)).to(self.device)

    def __len__(self) -> int:
        return len(self.s)

    def _assemble(self, idxs) -> Dict:
        specs = [self.s._item_spec(int(i)) for i in idxs]
        keys = ["s_from", "s_to"]
        if self.s.latent_taps >= 4:
            keys += ["s_outer_from", "s_outer_to"]
        if self.s.latent_taps == 6:
            keys += ["s_outer2_from", "s_outer2_to"]
        keys.append("between")
        # [B, k] flat slice ids in the slot order of _item_chans
        slots = np.array([[self._base[sp["vi"]] + sp[k] for k in keys]
                          for sp in specs], np.int64)
        idx = torch.from_numpy(slots).to(self.device, non_blocking=True)
        planes = self.flat_img[idx]                          # [B, k, P, P]
        if self.flat_lbl is not None:
            # slot-major: (image, label) per slot
            planes = torch.stack([planes, self.flat_lbl[idx]],
                                 dim=2).flatten(1, 2)
        if self.flat_mask is not None:
            planes = torch.cat([planes, self.flat_mask[idx[:, -1:]]], dim=1)
        return {
            "triplet": planes.permute(0, 2, 3, 1),
            "alpha_from": np.array([sp["a_from"] for sp in specs],
                                   np.float32),
            "alpha_to": np.array([sp["a_to"] for sp in specs], np.float32),
            "is_inbetween": np.array([sp["is_inbetween"] for sp in specs],
                                     np.float32),
            "patient_index": np.array([sp["vi"] for sp in specs], np.int32),
            "alpha_features": np.array(
                [sp["alpha_features"] for sp in specs], np.float32),
        }

    def sample_batch(self, batch_size: int) -> Dict:
        with span("data.gather"):
            sel = self.s.rs.randint(0, len(self.s._idcs), size=batch_size)
            return self._assemble(sel)

    def epoch_batches(self, batch_size: int):
        perm = self.s.rs.permutation(len(self.s._idcs))
        for start in range(0, len(perm) - batch_size + 1, batch_size):
            with span("data.gather"):
                batch = self._assemble(perm[start:start + batch_size])
            yield batch


def cache_nbytes(sampler: TripletSampler) -> int:
    """Bytes the cache would hold on the device for ``sampler`` (float32
    slices, labels and masks)."""
    stacks = list(sampler._padded)
    if sampler.has_labels:
        stacks += sampler._padded_labels
    if sampler.use_masks:
        stacks += sampler._padded_masks
    return sum(p.size * 4 for p in stacks)


def auto_budget_bytes(device) -> int:
    """The ``auto`` mode's budget on ``device``: ``SR_DEVICE_CACHE_MB``
    when it is set; else ``CUDA_FREE_SHARE`` of a CUDA device's free
    memory (the model is already on it); else ``DEFAULT_BUDGET_MB``."""
    env = os.environ.get("SR_DEVICE_CACHE_MB")
    if env is not None:
        return int(float(env) * 2 ** 20)
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[0] * CUDA_FREE_SHARE)
    return int(DEFAULT_BUDGET_MB * 2 ** 20)


def maybe_device_cache(sampler, mode, device, verbose: bool = False):
    """``sampler`` wrapped in a ``DeviceCachedSampler`` on ``device`` when
    ``mode`` asks for it: ``'1'`` always, ``'0'`` never, ``'auto'`` when
    its padded stacks fit ``auto_budget_bytes(device)``. Samplers that are
    not ``TripletSampler``s pass through."""
    smode = str(mode).lower() if mode is not None else "auto"
    if smode in ("0", "false", "off", "none"):
        return sampler
    if not isinstance(sampler, TripletSampler):
        return sampler
    nbytes = cache_nbytes(sampler)
    if smode not in ("1", "true", "on"):
        budget = auto_budget_bytes(device)
        if nbytes > budget:
            if verbose:
                print(f"device data cache: off ({nbytes / 2**20:.0f} MB "
                      f"> {budget / 2**20:.0f} MB budget — set "
                      f"SR_DEVICE_CACHE_MB or pass --device_data_cache 1)")
            return sampler
    if verbose:
        print(f"device data cache: on ({nbytes / 2**20:.1f} MB resident)")
    return DeviceCachedSampler(sampler, device)
