"""The serving surface the synthesis entry points take as ``trainer``.

Stand-in for an eval-mode ``Trainer`` of the JAX package
(``train/trainer.py:525-540``): ``model_config``, ``_ae_model()``,
``_ae_params()`` and ``params_sr`` (None here: the AE+CAISR combo's SR
model is loaded by ``Trainer.load_caisr``), plus the device the model
lives on.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..device import resolve_device
from ..models import AEConfig, build_model, flax_to_torch, reset_parameters


class ServingModel:
    """An eval-mode model of the ``ae_class`` registry (default
    ``VanillaACAI``) on one device.

    Weights come from ``state_dict`` (e.g. ``models.flax_to_torch``) or,
    when it is None, from ``models.reset_parameters(generator)``; one of
    the two is required. ``device=None`` means the CUDA device and
    raises without one (``device="cpu"`` runs on the CPU)."""

    params_sr = None

    def __init__(self, cfg: AEConfig,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 device=None, generator: Optional[torch.Generator] = None,
                 ae_class: str = "VanillaACAI"):
        self.device = resolve_device(device)
        self.model_config = cfg
        model = build_model(ae_class, cfg)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        elif generator is not None:
            reset_parameters(model, generator)
        else:
            raise ValueError("ServingModel needs a state_dict or a seeded "
                             "torch.Generator for its weights")
        self._model = model.to(self.device).eval().requires_grad_(False)
        # synthesis cores built for this model, keyed by
        # (decode_batch, latent_interp cache token)
        self.synth_cache: dict = {}

    @classmethod
    def from_flax(cls, cfg: AEConfig, params, batch_stats, device=None,
                  ae_class: str = "VanillaACAI") -> "ServingModel":
        """Serve a JAX-trained (params, batch_stats) tree of numpy arrays
        (a family's ``{"ae", …}`` tree serves its ``ae``)."""
        sd = flax_to_torch(params, batch_stats, cfg,
                           build_model(ae_class, cfg))
        return cls(cfg, sd, device, ae_class=ae_class)

    def _ae_model(self) -> torch.nn.Module:
        return self._model

    def _ae_params(self):
        """(parameters, buffers) of the model — the port's counterpart of
        the reference's (params, batch_stats)."""
        return (dict(self._model.named_parameters()),
                dict(self._model.named_buffers()))
