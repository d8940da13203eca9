"""Training data of the port: the triplet sampler, the device slice
cache, augmentation and batch shaping."""
from .device_cache import DeviceCachedSampler, maybe_device_cache
from .pairs import TripletSampler
from .transforms import (AugmentConfig, AugmentParams, apply_augment,
                         augment_batch, center_crop, device_batch,
                         draw_augment_params, pad_to_size,
                         prepare_batch_pairs, prepare_batch_quintets,
                         prepare_batch_septets)
from .volume import (Volume, create_lr_volume,
                     determine_interpol_coefficients,
                     get_random_adjacent_slice, simulate_thick_slices)

__all__ = ["AugmentConfig", "AugmentParams", "DeviceCachedSampler",
           "TripletSampler", "Volume", "apply_augment",
           "augment_batch", "center_crop", "create_lr_volume",
           "determine_interpol_coefficients", "device_batch",
           "draw_augment_params", "get_random_adjacent_slice",
           "maybe_device_cache", "pad_to_size",
           "prepare_batch_pairs", "prepare_batch_quintets",
           "prepare_batch_septets", "simulate_thick_slices"]
