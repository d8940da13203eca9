"""Training data of the port: the triplet sampler, the device slice
cache, augmentation and batch shaping; the ACDC evaluation sets and
centering, the brainMASI preparation."""
from .acdc_aux import (ACDCSRSegImage, acdc_sr_seg_fold, center_4d_volume,
                       create_centered_dataset, get_acdc_fold_patient_ids,
                       load_acdc_label_volumes, load_acdc_sr_seg_slices,
                       load_uncertainty_data, normalize_cardiac_label)
from .device_cache import DeviceCachedSampler, maybe_device_cache
from .masi import (create_masi_cropped_dataset, create_masi_lr_dataset,
                   crop_to_brain, find_bbox, masi_train_test_split)
from .pairs import TripletSampler
from .transforms import (AugmentConfig, AugmentParams, apply_augment,
                         augment_batch, center_crop, device_batch,
                         draw_augment_params, pad_to_size,
                         prepare_batch_pairs, prepare_batch_quintets,
                         prepare_batch_septets)
from .volume import (Volume, create_lr_volume,
                     determine_interpol_coefficients,
                     get_random_adjacent_slice, simulate_thick_slices)

__all__ = ["ACDCSRSegImage", "AugmentConfig", "AugmentParams",
           "DeviceCachedSampler", "TripletSampler", "Volume",
           "acdc_sr_seg_fold", "apply_augment", "augment_batch",
           "center_4d_volume", "center_crop", "create_centered_dataset",
           "create_lr_volume", "create_masi_cropped_dataset",
           "create_masi_lr_dataset", "crop_to_brain",
           "determine_interpol_coefficients", "device_batch",
           "draw_augment_params", "find_bbox", "get_acdc_fold_patient_ids",
           "get_random_adjacent_slice", "load_acdc_label_volumes",
           "load_acdc_sr_seg_slices", "load_uncertainty_data",
           "masi_train_test_split", "maybe_device_cache",
           "normalize_cardiac_label", "pad_to_size",
           "prepare_batch_pairs", "prepare_batch_quintets",
           "prepare_batch_septets", "simulate_thick_slices"]
