"""The port's command-line entry points (``python -m
superresolution_aniso_mri_tpu_torch.cli <command>``) and the shared
training loop."""
from .train_loop import build_augment_config, run_training

__all__ = ["build_augment_config", "run_training"]
