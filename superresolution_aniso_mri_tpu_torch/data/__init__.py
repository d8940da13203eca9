"""Training data of the port: the triplet sampler and batch shaping."""
from .pairs import TripletSampler
from .transforms import (AugmentConfig, augment_batch, center_crop,
                         device_batch, pad_to_size, prepare_batch_pairs,
                         prepare_batch_quintets, prepare_batch_septets)
from .volume import (Volume, determine_interpol_coefficients,
                     get_random_adjacent_slice)

__all__ = ["AugmentConfig", "TripletSampler", "Volume", "augment_batch",
           "center_crop", "determine_interpol_coefficients", "device_batch",
           "get_random_adjacent_slice", "pad_to_size", "prepare_batch_pairs",
           "prepare_batch_quintets", "prepare_batch_septets"]
