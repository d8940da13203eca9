"""Scoring of synthesized volumes: metrics, dataset evaluation,
checkpoint sweeps, training-time previews, the paper's evaluation
drivers (quantitative comparison, reconstruction, perceptual path
length, rigid-transform sensitivity, the AE+CAISR merge, SAX→LAX
resampling, segmentation and clinical metrics, the scoring of
segmentations of SR volumes) and model registries."""
from . import seg_metrics
from .clinical import (bland_altman_arrays, compute_phase_volumes,
                       exchange_base_apex, peak_rates, structure_volume,
                       volumes_over_time)
from .combine_ae_caisr import combine_volumes, create_combined_images
from .create_hr_images import (FILTER_BENCH, create_hr_images,
                               save_3d_volume, save_4d_volume, save_metrics)
from .drivers import (create_brain_volumes, create_cardiac_volumes,
                      evaluate_interpolation_performance,
                      test_interpolation_with_rigid_transformations)
from .evaluate_image import evaluate_image, generate_val_volume_grids
from .find_best_model import find_best_val_model, list_epoch_checkpoints
from .metrics_driver import (IdUniquifier, aggregate_metrics,
                             compute_volume_metrics)
from .model_registry import (BRAIN_MODEL_SPECS, CARDIAC_MODEL_SPECS,
                             get_trainer_for_spec, load_model_specs,
                             register_model)
from .ppl import compute_ppl
from .quantitative_comparison import (compare_quantitative,
                                      format_latex_string,
                                      generate_synth_slices_mask,
                                      load_results)
from .reconstruction import evaluate_model_reconstruction
from .sax_to_lax import (grid_sample_3d, make_identity_grid,
                         make_lax_identity_grid, make_transform,
                         resample_sax_to_lax)
from .sr_seg_eval import evaluate_sr_segmentation, score_segmentation
from .sweep import evaluate_volumes_batched, make_sweep_evaluator

__all__ = ["BRAIN_MODEL_SPECS", "CARDIAC_MODEL_SPECS", "FILTER_BENCH",
           "IdUniquifier", "aggregate_metrics", "bland_altman_arrays",
           "combine_volumes", "compare_quantitative",
           "compute_phase_volumes", "compute_ppl", "compute_volume_metrics",
           "create_brain_volumes", "create_cardiac_volumes",
           "create_combined_images", "create_hr_images", "evaluate_image",
           "evaluate_interpolation_performance",
           "evaluate_model_reconstruction", "evaluate_sr_segmentation",
           "evaluate_volumes_batched",
           "exchange_base_apex", "find_best_val_model",
           "format_latex_string", "generate_synth_slices_mask",
           "generate_val_volume_grids", "get_trainer_for_spec",
           "grid_sample_3d", "list_epoch_checkpoints", "load_model_specs",
           "load_results", "make_identity_grid", "make_lax_identity_grid",
           "make_sweep_evaluator", "make_transform", "peak_rates",
           "register_model", "resample_sax_to_lax", "save_3d_volume",
           "save_4d_volume", "save_metrics", "score_segmentation",
           "seg_metrics",
           "structure_volume", "test_interpolation_with_rigid_transformations",
           "volumes_over_time"]
