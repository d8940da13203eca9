"""Volume synthesis (serving) of the port, and the conventional
interpolation baselines."""
from .latent_taps import (fit_latent_taps, load_latent_taps,
                          resolve_latent_interp, save_latent_taps)
from .serving import ServingModel
from .super_volume import (apply_blur_filter, create_simple_interpolation,
                           create_super_volume, create_super_volumes,
                           interleave_volume, make_batched_synthesizer,
                           make_synthesis_core, make_volume_synthesizer,
                           rescale_volume, simple_interpolation)

__all__ = ["ServingModel", "apply_blur_filter",
           "create_simple_interpolation", "create_super_volume",
           "create_super_volumes", "fit_latent_taps", "load_latent_taps",
           "resolve_latent_interp", "save_latent_taps",
           "interleave_volume", "make_batched_synthesizer",
           "make_synthesis_core", "make_volume_synthesizer",
           "rescale_volume", "simple_interpolation"]
