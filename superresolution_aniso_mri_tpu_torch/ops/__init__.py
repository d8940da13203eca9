"""Compute ops of the port: losses, latent mixing, metrics, CUDA kernels."""
from .cuda_kernels import LAUNCHES, reset_launch_counts, ssim_volume_fused
from .lap_pyramid import lap_loss, laplacian_pyramid
from .losses import (LANCZOS3_OFFSETS, catmull_rom_weights,
                     lanczos3_weights, latent_mix, latent_mix_cubic,
                     latent_mix_lanczos3, mse)
from .metrics import (gaussian_filter2d, masked_mean, psnr2d, psnr_volume,
                      ssim2d, ssim_volume, synth_slice_mask, vif2d,
                      vif_volume)

__all__ = [
    "LANCZOS3_OFFSETS", "LAUNCHES", "catmull_rom_weights",
    "gaussian_filter2d", "lanczos3_weights", "lap_loss",
    "laplacian_pyramid", "latent_mix", "latent_mix_cubic",
    "latent_mix_lanczos3", "masked_mean", "mse",
    "psnr2d", "psnr_volume", "reset_launch_counts", "ssim2d",
    "ssim_volume", "ssim_volume_fused", "synth_slice_mask", "vif2d",
    "vif_volume",
]
