"""Compute ops of the port: latent mixing, metrics, CUDA kernels."""
from .cuda_kernels import LAUNCHES, reset_launch_counts, ssim_volume_fused
from .losses import (LANCZOS3_OFFSETS, catmull_rom_weights,
                     lanczos3_weights, latent_mix)
from .metrics import (gaussian_filter2d, masked_mean, psnr2d, psnr_volume,
                      ssim2d, ssim_volume, synth_slice_mask, vif2d,
                      vif_volume)

__all__ = [
    "LANCZOS3_OFFSETS", "LAUNCHES", "catmull_rom_weights",
    "gaussian_filter2d", "lanczos3_weights", "latent_mix", "masked_mean",
    "psnr2d", "psnr_volume", "reset_launch_counts", "ssim2d",
    "ssim_volume", "ssim_volume_fused", "synth_slice_mask", "vif2d",
    "vif_volume",
]
