"""The port's command-line entry points (``python -m
superresolution_aniso_mri_tpu_torch.cli <command>``)."""
