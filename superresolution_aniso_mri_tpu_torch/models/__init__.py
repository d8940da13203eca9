"""Model definitions of the port: VanillaACAI and the flax converters."""
from .acai import Decoder, Encoder, ResBlock, VanillaACAI
from .config import AEConfig
from .convert import flax_to_torch, torch_to_flax

__all__ = ["AEConfig", "Decoder", "Encoder", "ResBlock", "VanillaACAI",
           "flax_to_torch", "torch_to_flax"]
