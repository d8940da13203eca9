"""The β-VAE of the ``vae_combined`` recipe and its training step, as
plain functions of a parameter dict.

From the reference repository's ``networks/beta_vae.py:48-101`` (``VAE``)
and ``kwatsch/trainer_vae.py``: the VanillaACAI encoder and decoder of
``model.py``; the encoder's latent map flattened and sent through two
dense heads, μ and the log-variance, each as wide as the flat latent;
a sample ``z = μ + exp(logvar / 2) · eps`` reshaped to the latent map
and decoded through a sigmoid. The loss is ``λ · BCE + β · KL`` plus,
for the combined recipe, the synthesis term of the slice decoded from
the latents mixed at the in-between position.

Departures from the reference repository, each the port's as well:

- the flatten is of the NHWC latent, ``(h · W + w) · C + c``, not of the
  NCHW one: the JAX package's order, which the port keeps so that its
  heads are the flax kernels transposed;
- ``eps`` is an input (the program's recorded draw), not drawn here;
- the heads live on the same device as the trunk (the reference repo
  puts them on a second GPU, ``beta_vae.py:53,96-100``);
- BCE clips the decoded image to [1e-7, 1 - 1e-7], is summed over the
  elements and divided by the 2B images; the KL is the mean over μ's
  elements, not a sum;
- the synthesis term mixes the *sampled* z of the two slices, decodes
  the mix with its own batch statistics and weights each pair's MSE by
  ``is_inbetween``; only the main encode and decode move the running
  statistics;
- the μ of ``slice_between`` (both heads run) is computed for the logged
  ``loss_latent_1``, as the program computes it; it enters no gradient.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from .losses import mse, weighted
from .model import Arch, Net, is_buffer
from .model import param_shapes as trunk_shapes
from .precision import operands
from .train import Adam

HEADS = ("encoder_mu", "encoder_logvar")
BCE_EPS = 1e-7


def flat_size(arch: Arch) -> int:
    """Values of the flat latent: ``latent`` channels on the
    ``latent_width``² grid."""
    return arch.latent * arch.latent_width ** 2


def param_shapes(arch: Arch):
    """The trunk's ``model.param_shapes`` and the heads': each a
    ``dense_w`` [flat, flat] (``[out, in]``, the port's ``Dense``) and a
    ``bias`` [flat]."""
    out = trunk_shapes(arch)
    f = flat_size(arch)
    for head in HEADS:
        out[head + ".weight"] = ((f, f), "dense_w")
        out[head + ".bias"] = ((f,), "bias")
    return out


def trained_names(arch: Arch) -> List[str]:
    return [k for k in param_shapes(arch) if not is_buffer(k)]


def flatten_nhwc(z: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] → [N, H·W·C], the flat index ``(h · W + w) · C + c``."""
    return z.permute(0, 2, 3, 1).reshape(z.shape[0], -1)


def unflatten_nhwc(flat: torch.Tensor, arch: Arch) -> torch.Tensor:
    lw = arch.latent_width
    return flat.reshape(-1, lw, lw, arch.latent).permute(0, 3, 1, 2)


def heads(net: Net, z: torch.Tensor):
    """(μ, logvar) of the latent map ``z``."""
    flat, out = flatten_nhwc(z), []
    for head in HEADS:
        w, b = net.state[head + ".weight"], net.state[head + ".bias"]
        x, w, b = operands(net.mode, flat.device, flat, w, b)
        out.append(F.linear(x, w, b))
    return tuple(out)


def vae_combined_loss(net: Net, batch: Dict[str, torch.Tensor],
                      eps: torch.Tensor, mix_weight: float, beta: float,
                      lamb: float):
    """(loss, metrics) of one ``vae_combined`` step on ``batch`` with the
    reparametrisation noise ``eps`` [2B, flat]."""
    arch, x, between = net.arch, batch["image"], batch["slice_between"]
    b = between.shape[0]
    mu, logvar = heads(net, net.encode(x, train=True, update_stats=True))
    z = unflatten_nhwc(mu + torch.exp(logvar / 2) * eps, arch)
    out = net.decode(z, train=True, update_stats=True)
    p = out.clamp(BCE_EPS, 1.0 - BCE_EPS)
    bce = -(x * torch.log(p) + (1.0 - x) * torch.log1p(-p)).sum() / x.shape[0]
    kl = (-0.5 * logvar + 0.5 * (torch.exp(logvar) + mu ** 2) - 0.5).mean()
    shape = (b, 1, 1, 1)
    z_mix = (batch["alpha_from"].view(shape) * z[:b]
             + batch["alpha_to"].view(shape) * z[b:])
    s_mix = net.decode(z_mix, train=True)
    z_ref = unflatten_nhwc(heads(net, net.encode(between, train=True))[0],
                           arch)
    loss_mix = weighted(((between - s_mix) ** 2).mean(dim=(1, 2, 3)),
                        batch.get("is_inbetween"))
    total = lamb * bce + beta * kl + mix_weight * loss_mix
    return total, {"loss_ae": total.detach(), "loss_ae_dist": bce.detach(),
                   "kl_loss": (beta * kl).detach(),
                   "loss_latent_1": mse(z_mix, z_ref).detach()}


def follow(arch: Arch, init: Dict[str, torch.Tensor],
           batches: Sequence[Dict[str, torch.Tensor]],
           noise: Sequence[torch.Tensor], lr: float, b1: float,
           mix_weight: float, beta: float, lamb: float,
           mode: str = "float32",
           visit: Optional[Callable[[int, Dict, Dict], None]] = None):
    """Train from the state ``init`` on ``batches`` with the noise
    ``noise`` (one [2B, flat] draw a step), one Adam step each; after
    step ``i`` calls ``visit(i, gradients, parameters)``. ``init`` is
    read, never written: a step's tensors are new ones. Returns
    {"loss": [per step]}."""
    state = dict(init)
    names = [k for k in state if not is_buffer(k)]
    mu = {k: torch.zeros_like(state[k]) for k in names}
    nu = {k: torch.zeros_like(state[k]) for k in names}
    adam = Adam(lr, b1)
    losses = []
    for i, (batch, eps) in enumerate(zip(batches, noise), start=1):
        for k in names:
            state[k] = state[k].detach().requires_grad_(True)
        loss, _ = vae_combined_loss(Net(arch, state, mode), batch, eps,
                                    mix_weight, beta, lamb)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [state[k] for k in names])))
        losses.append(float(loss.detach()))
        params = {k: state[k].detach() for k in names}
        adam.step(params, grads, mu, nu, i)
        state.update(params)
        if visit is not None:
            visit(i, grads, params)
        del grads
    return {"loss": losses}
