"""Model architecture configuration.

Port of ``superresolution_aniso_mri_tpu/models/config.py``: the same
fields, derived ``scales``, validation and ``from_args``; ``dtype`` maps
the compute dtype name to a torch dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


@dataclasses.dataclass(frozen=True)
class AEConfig:
    """Architecture hyper-parameters of the autoencoder.

    ``scales = round(log2(width / latent_width))``; the encoder is
    shape-exact (``latent_width == width >> scales``). ``compute_dtype``
    is the dtype of the conv stacks; parameters stay float32.
    ``stem_pad_parity`` pads the 1x1 stem by one pixel like the original
    torch network (needs ``scales >= 2``)."""

    width: int = 128
    latent_width: int = 16
    depth: int = 32
    latent: int = 16
    colors: int = 1
    use_batchnorm: bool = True
    use_sigmoid: bool = True
    n_res_block: Optional[int] = None
    use_upsample: bool = True
    nclasses: int = 4
    compute_dtype: str = "float32"
    stem_pad_parity: bool = False

    def __post_init__(self):
        if self.scales < 0 or self.width != (self.latent_width
                                             << self.scales):
            raise ValueError(
                f"width ({self.width}) must be latent_width "
                f"({self.latent_width}) * a power of 2 — got ratio "
                f"{self.width / self.latent_width:g}")
        if self.stem_pad_parity and self.scales < 2:
            raise ValueError(
                "stem_pad_parity needs scales >= 2 (two pools absorb "
                "the +2 stem padding; at scales < 2 the reference "
                "latent grid is genuinely larger and incompatible with "
                "the shape-exact latent invariant)")
        if self.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of "
                             f"{tuple(_DTYPES)}, got {self.compute_dtype!r}")

    @property
    def scales(self) -> int:
        return int(round(math.log2(self.width / self.latent_width)))

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @classmethod
    def from_args(cls, args: dict) -> "AEConfig":
        """Build from a flat experiment-settings dict (settings.yaml)."""
        return cls(
            width=int(args["width"]),
            latent_width=int(args["latent_width"]),
            depth=int(args["depth"]),
            latent=int(args["latent"]),
            colors=int(args.get("colors", 1)),
            use_batchnorm=bool(args.get("use_batchnorm", False)),
            use_sigmoid=bool(args.get("use_sigmoid", False)),
            n_res_block=(int(args["n_res_block"])
                         if args.get("n_res_block") not in (None, "")
                         else None),
            use_upsample=bool(args.get("use_upsample", True)),
            nclasses=int(args.get("nclasses", 4)),
            compute_dtype=str(args.get("compute_dtype", "float32")),
            stem_pad_parity=bool(args.get("stem_pad_parity", False)),
        )
