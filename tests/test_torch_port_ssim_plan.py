"""PyTorch port, the SSIM kernel's launch geometry on the CPU.

``ops/cuda_kernels.py::ssim_plan`` cuts each slice's SSIM map into bands
of output rows and strips of output columns, one CTA each; the kernel
(``csrc/ssim.cu``) derives a CTA's rows and columns from its flat block
index with the index math mirrored in ``_tiles`` below. These tests walk
every CTA of awkward shapes and check that every map pixel is computed
exactly once, that each CTA's input window (its map pixels plus the
``win - 1`` halo) stays inside the slice, and that the plan meets the
kernel's own checks (``ssim_volume_f32``). No card is needed.
"""
import numpy as np
import pytest

from superresolution_aniso_mri_tpu_torch.ops import cuda_kernels as ck

H100_SMS = 132
SHAPES = [(175, 220, 220), (8, 256, 256), (5, 129, 97), (3, 64, 1500),
          (4, 37, 64), (2, 11, 11), (3, 7, 9), (1, 300, 2049),
          (70000, 8, 8), (14, 30, 34), (1, 1000, 13)]


def _tiles(plan, s, h, w, win):
    """Per CTA, as ssim_band_kernel computes them: (slice, first output
    row, output rows, first output column, output columns)."""
    oh, ow = h - win + 1, w - win + 1
    per_slice = plan.bands * plan.strips
    for block in range(s * per_slice):
        sl, tile = divmod(block, per_slice)
        band, strip = divmod(tile, plan.strips)
        y0, x0 = band * plan.band_rows, strip * plan.strip_cols
        yield (sl, y0, min(plan.band_rows, oh - y0), x0,
               min(plan.strip_cols, ow - x0))


@pytest.mark.parametrize("shape, win", [
    (shape, win) for shape in SHAPES for win in ck.SSIM_WINDOWS
    if win <= min(shape[1:])], ids=lambda v: "x".join(map(str, v))
    if isinstance(v, tuple) else str(v))
def test_plan_covers_every_map_pixel_once_with_its_halo(shape, win):
    s, h, w = shape
    plan = ck.ssim_plan(s, h, w, win, H100_SMS)
    oh, ow = h - win + 1, w - win + 1
    # the checks ssim_volume_f32 makes before it launches
    assert plan.bands * plan.band_rows >= oh > (plan.bands - 1) * plan.band_rows
    assert plan.strips * plan.strip_cols >= ow > (plan.strips - 1) * plan.strip_cols
    assert plan.strip_cols <= ck.MAX_STRIP_OUT
    assert plan.threads % 32 == 0 and plan.threads <= ck.MAX_THREADS
    assert s * plan.ctas_per_slice <= 2 ** 31 - 1
    slices = min(s, 3)          # every slice is cut alike
    count = np.zeros((slices, oh, ow), np.int32)
    for sl, y0, rows, x0, cols in _tiles(plan, slices, h, w, win):
        assert rows >= 1 and cols >= 1
        cols_in = cols + win - 1
        assert ck.COLS_PER_THREAD * plan.threads >= cols_in
        assert y0 + rows + win - 1 <= h and x0 + cols_in <= w   # halo inside
        count[sl, y0:y0 + rows, x0:x0 + cols] += 1
    np.testing.assert_array_equal(count, 1)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_loads_stay_inside_the_row(shape):
    """A thread loads a column only below its strip's input width
    (``load_cols``); every such column lies inside the row, and the
    strip's threads load each of its input columns once."""
    s, h, w = shape
    for win in [v for v in ck.SSIM_WINDOWS if v <= min(h, w)]:
        plan = ck.ssim_plan(s, h, w, win, H100_SMS)
        for strip in range(plan.strips):
            x0 = strip * plan.strip_cols
            cols_in = min(plan.strip_cols, w - win + 1 - x0) + win - 1
            loaded = [c + e for c in range(0, ck.COLS_PER_THREAD
                                           * plan.threads,
                                           ck.COLS_PER_THREAD)
                      for e in range(ck.COLS_PER_THREAD) if c + e < cols_in]
            assert loaded == list(range(cols_in))
            assert x0 + cols_in <= w


def test_plan_band_height_follows_the_card():
    """Bands are as tall as still gives CTAS_PER_SM CTAs per SM, within
    MIN_BAND_ROWS..MAX_BAND_ROWS."""
    big = ck.ssim_plan(175, 220, 220, 7, H100_SMS)   # OASIS: tall bands
    assert big.bands * 175 >= ck.CTAS_PER_SM * H100_SMS
    assert (big.band_rows, big.bands) == (36, 6)
    small = ck.ssim_plan(8, 256, 256, 7, H100_SMS)   # few slices: short
    assert small.band_rows <= ck.MIN_BAND_ROWS
    assert ck.ssim_plan(175, 220, 220, 7, 1000).band_rows == ck.MIN_BAND_ROWS


def test_plan_lifts_the_grid_z_slice_limit():
    """Slices ride the flat grid dimension: 70,000 slices (more than the
    65,535 of a grid's z dimension) are one CTA each."""
    plan = ck.ssim_plan(70000, 8, 8, 7, H100_SMS)
    assert plan.ctas_per_slice == 1 and 70000 * plan.ctas_per_slice > 65535


def test_plan_rejects_slices_smaller_than_the_window():
    with pytest.raises(ValueError, match="window"):
        ck.ssim_plan(2, 6, 20, 7, H100_SMS)
