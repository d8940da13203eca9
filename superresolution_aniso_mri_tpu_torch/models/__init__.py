"""Model definitions of the port (serving: eval-mode VanillaACAI)."""
from .acai import Decoder, Encoder, ResBlock, VanillaACAI
from .config import AEConfig
from .convert import flax_to_torch

__all__ = ["AEConfig", "Decoder", "Encoder", "ResBlock", "VanillaACAI",
           "flax_to_torch"]
