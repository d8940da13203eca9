"""Model definitions of the port (the ``ae_class`` registry's classes,
the alpha probes, the legacy block models), the registry and the flax
converters."""
from .acai import (Decoder, Discriminator, Encoder, ResBlock, VanillaACAI,
                   lerp, reset_parameters, swap_halves)
from .alpha import AlphaDecoder, SELayer, make_alpha_probe
from .config import AEConfig
from .convert import flax_to_torch, torch_to_flax
from .legacy import (DiscriminatorFakeReal, DiscriminatorSpatial, LegacyAE,
                     LegacyAEAdv, bilinear_upsample2x)
from .multi_channel import MultiChannelAE
from .vae import VAE, VAE2
from .variants import LargerAE, VanillaACAIStrided

MODEL_REGISTRY = {
    "VanillaACAI": VanillaACAI,
    "VAE": VAE,
    "VAE2": VAE2,
    "MultiChannelAE": MultiChannelAE,
    "LargerAE": LargerAE,
    "VanillaACAIStrided": VanillaACAIStrided,
}


def model_config(model) -> AEConfig:
    """The ``AEConfig`` of a model, or of the AE of an ``{"ae", …}``
    family ``ModuleDict``."""
    return model.config if hasattr(model, "config") else model["ae"].config


def build_model(ae_class: str, config: AEConfig):
    """Instantiate a model by its ``ae_class`` registry name (with zero
    weights: ``reset_parameters`` or a state dict fills them)."""
    if ae_class not in MODEL_REGISTRY:
        raise ValueError(f"unknown ae_class {ae_class!r}; known: "
                         f"{sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[ae_class](config)


__all__ = ["AEConfig", "AlphaDecoder", "Decoder", "Discriminator",
           "DiscriminatorFakeReal", "DiscriminatorSpatial", "Encoder",
           "LargerAE", "LegacyAE", "LegacyAEAdv", "MODEL_REGISTRY",
           "MultiChannelAE", "ResBlock", "SELayer", "VAE", "VAE2",
           "VanillaACAI", "VanillaACAIStrided", "bilinear_upsample2x",
           "build_model", "flax_to_torch", "lerp", "make_alpha_probe",
           "model_config", "reset_parameters", "swap_halves",
           "torch_to_flax"]
