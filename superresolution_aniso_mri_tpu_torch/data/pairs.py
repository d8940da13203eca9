"""Slice-triplet sampling: the training-data contract.

A numpy copy of ``superresolution_aniso_mri_tpu/data/pairs.py``
(``TripletSampler``, ``latent_taps`` 2/4/6). It draws from the same
``RandomState`` stream in the same order, so a seed gives bitwise the
same batches as the JAX package's sampler. Batches are assembled with
numpy (the JAX package's native gather gives the same bits); loss masks
(``use_masks``) are not ported yet.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .transforms import pad_to_size
from .volume import (Volume, determine_interpol_coefficients,
                     get_random_adjacent_slice)


class TripletSampler:
    """Samples (slice_from, slice_to, slice_between, alphas) triplets.

    ``slice_selection`` semantics (reference: common_brains.py:272-282):
      * 'adjacent'       → neighbour at step 1
      * 'adjacent_plus'  → neighbour at step = downsample_steps
      * 'mix'            → random choice of the two
    The in-between slice is drawn uniformly inside the open gap, and
    alpha_from/alpha_to are its relative positions. The from/to order is
    randomly swapped, matching the reference.
    """

    def __init__(self, volumes: Sequence[Volume], downsample_steps: int,
                 slice_selection: str = "adjacent_plus",
                 pad_size: int | None = None,
                 seed: int = 1234, use_masks: bool = False,
                 latent_taps: int = 2):
        if use_masks:
            raise NotImplementedError(
                "use_masks (--get_masks loss masks) is not ported yet "
                "(ROADMAP item 6)")
        if slice_selection not in ("adjacent", "adjacent_plus", "mix"):
            raise ValueError(f"bad slice_selection {slice_selection!r}")
        if latent_taps not in (2, 4, 6):
            raise ValueError(f"latent_taps must be 2 (triplets), 4 "
                             f"(quintets for cubic-aligned training) or "
                             f"6 (septets for lanczos3-aligned "
                             f"training), got {latent_taps}")
        # 4/6-tap modes: each item also carries the outward z-neighbours
        # (outer_from/outer_to one pair step beyond from/to — and for 6
        # taps outer2_from/outer2_to two pair steps beyond — clamped at
        # the volume edges like inference's multi-tap boundary taps) so
        # the training loss can mix latents with the same spline kernel
        # the cubic/lanczos3 inference paths use
        self.latent_taps = int(latent_taps)
        self.volumes = list(volumes)
        if not self.volumes:
            # fail HERE with the real cause — downstream it surfaces as
            # an opaque "max() arg is an empty sequence"
            raise ValueError(
                "TripletSampler: no volumes to sample from (empty "
                "dataset path or a split/patient filter removed "
                "everything)")
        self.downsample_steps = int(downsample_steps)
        self.slice_selection = slice_selection
        self.rs = np.random.RandomState(seed)
        # flat index of (volume_idx, slice_idx) like BrainDataset._get_indices
        idcs: List[tuple] = []
        for vi, vol in enumerate(self.volumes):
            for s in range(vol.num_slices):
                idcs.append((vi, s))
        self._idcs = np.asarray(idcs, np.int64)
        hs = [v.image.shape[1] for v in self.volumes]
        ws = [v.image.shape[2] for v in self.volumes]
        # pad_size is a LOWER bound: every volume must pad to one common
        # shape, so heterogeneous in-plane sizes (per-patient FOVs after
        # resampling) take the max — a smaller fixed pad would mix
        # shapes inside one batch (numpy stack crash). The device-side
        # augmentation crops back down to the patch size.
        biggest = max(max(hs), max(ws))
        self.pad_size = (biggest if pad_size is None
                         else max(int(pad_size), biggest))
        # pad every volume ONCE at construction — per-item padding was
        # the sampler's hot spot (3 HxW copies per sample)
        self._padded = [pad_to_size(v.image, self.pad_size)
                        for v in self.volumes]
        # multichannel (ACDCLBL) path: pair a label channel with every
        # image channel (reference: datasets/ACDC/data_with_labels.py —
        # 6-channel (img+lbl)x3 triplets)
        self.has_labels = all(v.labels is not None for v in self.volumes)
        self._padded_labels = (
            [pad_to_size(np.asarray(v.labels, np.float32), self.pad_size)
             for v in self.volumes] if self.has_labels else None)

    def __len__(self) -> int:
        return len(self._idcs)

    def _slice_step(self) -> int:
        if self.slice_selection == "adjacent":
            return 1
        if self.slice_selection == "adjacent_plus":
            return self.downsample_steps
        return int(self.rs.choice([1, self.downsample_steps]))

    def _item_spec(self, idx: int) -> Dict[str, float]:
        """All the RNG decisions for one item (indices + alphas). Kept
        separate from pixel assembly so the seeded draw order is
        identical between the per-item and batched paths."""
        vi, s1 = self._idcs[idx]
        vol = self.volumes[int(vi)]
        n = vol.num_slices
        step = max(1, min(self._slice_step(), n - 1))
        s2 = get_random_adjacent_slice(int(s1), n, self.rs, step=step)
        lo, hi = min(s1, s2), max(s1, s2)
        if hi - lo > 1:
            between = int(self.rs.choice(np.arange(lo + 1, hi)))
        else:
            between = int(lo)  # degenerate gap (step 1): monitor-only
        if self.rs.choice([0, 1]) == 0:
            s_from, s_to = int(s1), int(s2)
        else:
            s_from, s_to = int(s2), int(s1)
        if hi - lo > 1:
            a_from, a_to = determine_interpol_coefficients(s_from, s_to, between)
        else:
            a_from, a_to = 0.5, 0.5
        # scalar features for the alpha probes (reference:
        # base_alpha_trainer.py:178-189 create_add_features —
        # [(s_from+1)/n, (s_to+1)/n, (frame+1)/n_frames, z-spacing, n])
        frame = float(getattr(vol, "frame_id", 0) or 0)
        n_frames = float(getattr(vol, "num_frames", 1) or 1)
        feats = (float(s_from + 1) / n, float(s_to + 1) / n,
                 (frame + 1.0) / n_frames, float(vol.spacing[0]), float(n))
        spec = {"vi": int(vi), "s_from": s_from, "s_to": s_to,
                "between": between, "a_from": a_from, "a_to": a_to,
                "is_inbetween": float(hi - lo > 1),
                "alpha_features": feats}
        if self.latent_taps >= 4:
            # outward neighbours continue the from→to direction one pair
            # step beyond each end, clamped at the volume edges — the
            # training-time twin of the cubic inference taps
            # z[max(j-1,0)] / z[min(j+2,K-1)] on the kept grid
            d = s_to - s_from
            spec["s_outer_from"] = int(np.clip(s_from - d, 0, n - 1))
            spec["s_outer_to"] = int(np.clip(s_to + d, 0, n - 1))
        if self.latent_taps == 6:
            # two pair steps beyond each end — the lanczos3 inference
            # taps z[clip(j-2)] / z[clip(j+3)] on the kept grid
            d = s_to - s_from
            spec["s_outer2_from"] = int(np.clip(s_from - 2 * d, 0, n - 1))
            spec["s_outer2_to"] = int(np.clip(s_to + 2 * d, 0, n - 1))
        return spec

    def _item_chans(self, spec) -> list:
        """The C channel planes (contiguous [H, W] float32 views) of one
        triplet, in the slot-major layout prepare_batch_pairs expects."""
        vi = spec["vi"]
        s_from, s_to, between = spec["s_from"], spec["s_to"], spec["between"]
        img = self._padded[vi]
        # slot order: (from, to[, outer_from, outer_to
        # [, outer2_from, outer2_to]], between) — the
        # between slot stays LAST so prepare_batch_pairs/_quintets/_septets and
        # the riding-mask split share one layout rule
        slots = [s_from, s_to]
        if self.latent_taps >= 4:
            slots += [spec["s_outer_from"], spec["s_outer_to"]]
        if self.latent_taps == 6:
            slots += [spec["s_outer2_from"], spec["s_outer2_to"]]
        slots.append(between)
        if self.has_labels:
            lbl = self._padded_labels[vi]
            # slot-major channel layout, C=2 (image, label) per slot —
            # prepare_batch_pairs slices per slot
            chans = []
            for s in slots:
                chans += [img[s], lbl[s]]
        else:
            chans = [img[s] for s in slots]
        return chans

    def sample_item(self, idx: int) -> Dict[str, np.ndarray]:
        spec = self._item_spec(idx)
        triplet = np.stack(self._item_chans(spec), axis=-1)
        return {
            "triplet": triplet.astype(np.float32, copy=False),
            "alpha_from": np.float32(spec["a_from"]),
            "alpha_to": np.float32(spec["a_to"]),
            "is_inbetween": np.float32(spec["is_inbetween"]),
            "patient_index": np.int32(spec["vi"]),
            "alpha_features": np.asarray(spec["alpha_features"], np.float32),
        }

    def _assemble_batch(self, idxs) -> Dict[str, np.ndarray]:
        """Batched assembly: the numpy per-item stack."""
        specs = [self._item_spec(int(i)) for i in idxs]
        triplets = np.stack([np.stack(self._item_chans(s), axis=-1)
                             for s in specs]).astype(np.float32, copy=False)
        return {
            "triplet": triplets,
            "alpha_from": np.array([s["a_from"] for s in specs], np.float32),
            "alpha_to": np.array([s["a_to"] for s in specs], np.float32),
            "is_inbetween": np.array([s["is_inbetween"] for s in specs],
                                     np.float32),
            "patient_index": np.array([s["vi"] for s in specs], np.int32),
            "alpha_features": np.array([s["alpha_features"] for s in specs],
                                       np.float32),
        }

    def sample_batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        """One random batch (with-replacement permutation sampling like
        MyRandomSampler + drop_last)."""
        sel = self.rs.randint(0, len(self._idcs), size=batch_size)
        return self._assemble_batch(sel)

    def epoch_batches(self, batch_size: int):
        """Deterministic epoch: a seeded permutation of all indices,
        chunked into full batches (drop_last)."""
        perm = self.rs.permutation(len(self._idcs))
        for start in range(0, len(perm) - batch_size + 1, batch_size):
            yield self._assemble_batch(perm[start:start + batch_size])
