"""Compute ops of the port: losses (Dice included), latent mixing,
metrics, perceptual distances, CUDA kernels."""
from .cuda_kernels import LAUNCHES, reset_launch_counts, ssim_volume_fused
from .dice import dice_loss, soft_dice_score
from .lap_pyramid import lap_loss, laplacian_pyramid
from .losses import (LANCZOS3_OFFSETS, bce_sum_over_batch,
                     catmull_rom_weights, kl_standard_normal,
                     lanczos3_weights, latent_mix, latent_mix_cubic,
                     l1, latent_mix_lanczos3, mse)
from .lpips import (get_lpips_params, init_lpips_params, load_lin_weights,
                    load_lpips_params, lpips_distance, lpips_loss,
                    lpips_weights_info)
from .metrics import (gaussian_filter2d, masked_mean, msssim2d,
                      msssim_volume, psnr2d, psnr_volume, ssim2d,
                      ssim_volume, synth_slice_mask, vif2d, vif_volume)
from .perceptual import (enc_lpips_distance, enc_perceptual_loss,
                         get_enc_perceptual_params, load_enc_perceptual,
                         save_enc_perceptual)

__all__ = [
    "LANCZOS3_OFFSETS", "LAUNCHES", "bce_sum_over_batch",
    "catmull_rom_weights", "dice_loss", "kl_standard_normal",
    "enc_lpips_distance", "enc_perceptual_loss", "gaussian_filter2d",
    "get_enc_perceptual_params", "get_lpips_params", "init_lpips_params",
    "l1",
    "lanczos3_weights", "lap_loss", "laplacian_pyramid", "latent_mix",
    "latent_mix_cubic", "latent_mix_lanczos3", "load_enc_perceptual",
    "load_lin_weights", "load_lpips_params", "lpips_distance", "lpips_loss",
    "lpips_weights_info", "masked_mean", "mse", "msssim2d",
    "msssim_volume", "psnr2d", "psnr_volume", "reset_launch_counts",
    "save_enc_perceptual", "soft_dice_score", "ssim2d", "ssim_volume",
    "ssim_volume_fused", "synth_slice_mask", "vif2d", "vif_volume",
]
