"""Volume synthesis (serving) of the port."""
from .latent_taps import resolve_latent_interp
from .serving import ServingModel
from .super_volume import (create_super_volume, create_super_volumes,
                           interleave_volume, make_batched_synthesizer,
                           make_synthesis_core, make_volume_synthesizer)

__all__ = ["ServingModel", "create_super_volume", "create_super_volumes",
           "resolve_latent_interp",
           "interleave_volume", "make_batched_synthesizer",
           "make_synthesis_core", "make_volume_synthesizer"]
