"""Volume synthesis (serving) of the port, the conventional
interpolation baselines, probe-predicted mixes and patch-tiled
reconstruction."""
from .alpha_interp import (create_features, get_alpha_probe_features,
                           latent_space_interp_pred_alpha,
                           synthesize_cardiac_features)
from .latent_taps import (fit_latent_taps, fitted_tap_weights,
                          load_latent_taps, resolve_latent_interp,
                          save_latent_taps)
from .patches import (assemble_patches, extract_patches,
                      interpolate_in_patches, reconstruct_in_patches)
from .serving import ServingModel
from .super_volume import (apply_blur_filter, create_simple_interpolation,
                           create_super_volume, create_super_volumes,
                           interleave_volume, latent_space_interp,
                           make_batched_synthesizer,
                           make_synthesis_core, make_volume_synthesizer,
                           rescale_volume, simple_interpolation)

__all__ = ["ServingModel", "apply_blur_filter", "assemble_patches",
           "create_features", "create_simple_interpolation",
           "create_super_volume", "create_super_volumes", "extract_patches",
           "fit_latent_taps", "fitted_tap_weights",
           "get_alpha_probe_features",
           "interpolate_in_patches", "latent_space_interp",
           "latent_space_interp_pred_alpha",
           "load_latent_taps", "reconstruct_in_patches",
           "synthesize_cardiac_features",
           "resolve_latent_interp", "save_latent_taps",
           "interleave_volume", "make_batched_synthesizer",
           "make_synthesis_core", "make_volume_synthesizer",
           "rescale_volume", "simple_interpolation"]
