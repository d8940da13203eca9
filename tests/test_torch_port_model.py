"""PyTorch port, model layer: AEConfig, VanillaACAI and the flax →
torch converter, held against the JAX package on the CPU.

Inputs and weights come from numpy seeds and reach both frameworks as
numpy arrays. Tolerances: float32 outputs within 1e-4 of JAX run at
``jax.default_matmul_precision("highest")`` (the two differ only in
the order of float32 sums); bfloat16 compute within the bound stated
in ``test_bf16_compute_matches_jax``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_aniso_mri_tpu.models import AEConfig as JaxConfig
from superresolution_aniso_mri_tpu.models import VanillaACAI as JaxACAI
from superresolution_aniso_mri_tpu_torch.models import (AEConfig,
                                                        VanillaACAI,
                                                        flax_to_torch)
from torch_port_helpers import SMALL
from torch_port_helpers import jax_model as _jax_model

F32_ATOL = 1e-4


def _variables(params, stats):
    return {"params": params, **({"batch_stats": stats} if stats else {})}


def _jit_apply(model, method):
    """One compiled program per call site: op-by-op flax dispatch
    compiles every primitive separately and is far slower on the CPU."""
    return jax.jit(lambda v, x: model.apply(v, x,
                                            method=getattr(model, method)))


def _port(params, stats, **kw):
    cfg = AEConfig(**SMALL, **kw)
    m = VanillaACAI(cfg)
    m.load_state_dict(flax_to_torch(params, stats, cfg))
    return m.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


ARCHS = {
    "bn": dict(),
    "no_bn": dict(use_batchnorm=False),
    "stem_pad_parity": dict(stem_pad_parity=True),
    "res_block": dict(n_res_block=1),
    "conv_transpose": dict(use_upsample=False),
}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_encode_decode_forward_match_jax_f32(arch):
    kw = ARCHS[arch]
    model, params, stats = _jax_model(**kw)
    port = _port(params, stats, **kw)
    rng = np.random.RandomState(1)
    x = rng.rand(3, 32, 36, 1).astype(np.float32)
    z_in = rng.randn(3, 8, 9, SMALL["latent"]).astype(np.float32)
    v = _variables(params, stats)
    with jax.default_matmul_precision("highest"):
        z = np.asarray(_jit_apply(model, "encode")(v, x))
        y = np.asarray(_jit_apply(model, "decode")(v, z_in))
        full = np.asarray(_jit_apply(model, "__call__")(v, x))
    with torch.no_grad():
        np.testing.assert_allclose(_nhwc(port.encode(_nchw(x))), z,
                                   atol=F32_ATOL)
        np.testing.assert_allclose(_nhwc(port.decode(_nchw(z_in))), y,
                                   atol=F32_ATOL)
        np.testing.assert_allclose(_nhwc(port(_nchw(x))), full,
                                   atol=F32_ATOL)


def test_conv_transpose_mapping_matches_flax():
    """One flax ConvTranspose(4, s=2, padding=((2,2),(2,2))) block against
    the port's transposed conv with the converted (flipped) kernel:
    shape 2n and values, on a non-square input."""
    import flax.linen as fnn

    from superresolution_aniso_mri_tpu_torch.models.acai import ConvTranspose
    from superresolution_aniso_mri_tpu_torch.models.convert import (
        _conv_transpose_weight)

    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    layer = fnn.ConvTranspose(3, (4, 4), strides=(2, 2),
                              padding=((2, 2), (2, 2)))
    kernel = rng.randn(4, 4, 3, 3).astype(np.float32)
    bias = rng.randn(3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(layer.apply(
            {"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x)))
    port = ConvTranspose(3)
    port.load_state_dict({"weight": torch.tensor(_conv_transpose_weight(kernel).copy()),
                          "bias": torch.tensor(bias)})
    with torch.no_grad():
        got = _nhwc(port(_nchw(x)))
    assert got.shape == want.shape == (2, 10, 14, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_bf16_compute_matches_jax():
    """compute_dtype='bfloat16': both frameworks cast activations and
    float32 params to bf16 per conv and normalise BN in float32, but
    round at different places inside a conv (bias add, accumulation).
    Measured gap over seeds 0-2 of this model: at most 4.9e-3 on the
    latent (|z| <= 0.44) and 4.1e-3 on the sigmoid output (one bf16 ulp
    at 0.5 is 2e-3); the bounds are 1.5e-2 and 1e-2, against 1e-4 in
    float32."""
    model, params, stats = _jax_model()
    jm = JaxACAI(JaxConfig(**SMALL, compute_dtype="bfloat16"))
    port = _port(params, stats, compute_dtype="bfloat16")
    x = np.random.RandomState(3).rand(4, 32, 32, 1).astype(np.float32)
    v = _variables(params, stats)
    z = np.asarray(_jit_apply(jm, "encode")(v, x))
    y = np.asarray(_jit_apply(jm, "__call__")(v, x))
    with torch.no_grad():
        zt = port.encode(_nchw(x))
        yt = port(_nchw(x))
    assert zt.dtype == yt.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(zt), z, atol=1.5e-2)
    np.testing.assert_allclose(_nhwc(yt), y, atol=1e-2)


def test_converter_rejects_mismatched_architecture():
    _model, params, stats = _jax_model()
    with pytest.raises(ValueError, match="does not match"):
        flax_to_torch(params, stats, AEConfig(**SMALL, n_res_block=1))
    with pytest.raises(ValueError, match="batch_stats"):
        flax_to_torch(params, {}, AEConfig(**SMALL))
    wide = dict(SMALL, depth=8)
    with pytest.raises(ValueError, match="shape"):
        flax_to_torch(params, stats, AEConfig(**wide))


def test_converter_accepts_family_wrapper():
    _model, params, stats = _jax_model()
    cfg = AEConfig(**SMALL)
    a = flax_to_torch(params, stats, cfg)
    b = flax_to_torch({"ae": params, "disc": {}}, {"ae": stats}, cfg)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k])


@pytest.mark.parametrize("args", [
    dict(width=64, latent_width=16, depth=32, latent=128),
    dict(width="128", latent_width="16", depth="8", latent="4",
         use_batchnorm=1, use_sigmoid=0, n_res_block="", colors=2,
         compute_dtype="bfloat16", stem_pad_parity=True),
    dict(width=32, latent_width=8, depth=4, latent=6, n_res_block="2",
         use_upsample=False),
])
def test_config_from_args_matches_jax(args):
    j = JaxConfig.from_args(args)
    t = AEConfig.from_args(args)
    for field in ("width", "latent_width", "depth", "latent", "colors",
                  "use_batchnorm", "use_sigmoid", "n_res_block",
                  "use_upsample", "nclasses", "compute_dtype",
                  "stem_pad_parity", "scales"):
        assert getattr(t, field) == getattr(j, field), field
    assert t.dtype == {"float32": torch.float32,
                       "bfloat16": torch.bfloat16}[t.compute_dtype]


@pytest.mark.parametrize("kw, match", [
    (dict(width=48, latent_width=16), "power of 2"),
    (dict(width=16, latent_width=32), "power of 2"),
    (dict(width=32, latent_width=16, stem_pad_parity=True), "scales >= 2"),
])
def test_config_validation_matches_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        JaxConfig(**kw)
    with pytest.raises(ValueError, match=match):
        AEConfig(**kw)


def test_reset_parameters_is_seeded_acai_init():
    cfg = AEConfig(**SMALL, n_res_block=1, use_upsample=False)
    a, b = VanillaACAI(cfg), VanillaACAI(cfg)
    a.reset_parameters(torch.Generator().manual_seed(7))
    b.reset_parameters(torch.Generator().manual_seed(7))
    for (name, pa), pb in zip(a.state_dict().items(),
                              b.state_dict().values()):
        assert torch.equal(pa, pb), name
    # std = 1/sqrt(1.04 * fan_in), fan_in = kh*kw*in: the encoder
    # ResBlock's 3x3 conv reads 8 channels (3*3*8) into 128
    w = a.enc.res[0].conv0.weight
    want = 1.0 / np.sqrt(1.04 * 3 * 3 * 8)
    assert abs(float(w.detach().std()) / want - 1.0) < 0.1
    assert float(a.enc.bns[0].running_var.min()) == 1.0
