"""Scoring of synthesized volumes: metrics, dataset evaluation,
checkpoint sweeps, training-time previews."""
from .create_hr_images import (FILTER_BENCH, create_hr_images,
                               save_3d_volume, save_4d_volume, save_metrics)
from .evaluate_image import evaluate_image, generate_val_volume_grids
from .find_best_model import find_best_val_model, list_epoch_checkpoints
from .metrics_driver import (IdUniquifier, aggregate_metrics,
                             compute_volume_metrics)
from .sweep import evaluate_volumes_batched, make_sweep_evaluator

__all__ = ["FILTER_BENCH", "IdUniquifier", "aggregate_metrics",
           "compute_volume_metrics", "create_hr_images", "evaluate_image",
           "evaluate_volumes_batched", "find_best_val_model",
           "generate_val_volume_grids", "list_epoch_checkpoints",
           "make_sweep_evaluator", "save_3d_volume", "save_4d_volume",
           "save_metrics"]
