"""Parity of sliders_tpu_torch.ops.basic with sliders_tpu.ops.basic on the CPU.

The same numpy inputs (seeded) and the same weights (JAX layouts carried over
by models.convert.from_jax_params) go through both; f32 everywhere. The
tolerance is 1e-5 (relative and absolute): only the summation order differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_tpu.lora.batch import stack_sliders as jax_stack_sliders
from sliders_tpu.ops import basic as jb
from sliders_tpu_torch.models.convert import from_jax_params
from sliders_tpu_torch.ops import basic as tb

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _lora_entry(rng, down_shape, up_shape, alpha):
    return {"down": _normal(rng, *down_shape, scale=0.3), "up": _normal(rng, *up_shape, scale=0.3),
            "alpha": np.float32(alpha)}


def _to_jax(tree):
    return {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in tree.items()}


def _loras(jax_weights, multiplier):
    """(JAX SliderLora, port SliderLora) over the same weights."""
    np_weights = {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in jax_weights.items()}
    return (jb.SliderLora(weights=jax_weights, multiplier=jnp.asarray(multiplier, jnp.float32)),
            tb.SliderLora(weights=from_jax_params(np_weights),
                          multiplier=torch.as_tensor(np.asarray(multiplier, np.float32))))


@pytest.mark.parametrize("mode", ["none", "scalar", "vector", "stacked"])
def test_linear_with_lora(mode):
    rng = _rng(1)
    B, L, din, dout = 3, 5, 12, 10
    w, b = _normal(rng, din, dout), _normal(rng, dout)
    x = _normal(rng, B, L, din)
    jl, tl = None, None
    if mode != "none":
        if mode == "stacked":
            trees = [{"m": _lora_entry(rng, (din, r), (r, dout), a)}
                     for r, a in ((2, 1.0), (4, 2.0), (2, 0.5))]
            jw = jax_stack_sliders([_to_jax(t) for t in trees])
        else:
            jw = _to_jax({"m": _lora_entry(rng, (din, 4), (4, dout), 1.5)})
        mult = 0.7 if mode == "scalar" else np.array([-1.0, 0.5, 2.0], np.float32)
        jl, tl = _loras(jw, mult)
    ref = jb.linear({"weight": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x),
                    lora=jl, name="m")
    out = tb.linear({"weight": torch.from_numpy(w.T.copy()), "bias": torch.from_numpy(b)},
                    torch.from_numpy(x), lora=tl, name="m")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("mode", ["none", "scalar", "vector", "stacked"])
@pytest.mark.parametrize("stride,k", [(1, 3), (2, 3), (1, 1)])
def test_conv2d_with_lora(mode, stride, k):
    rng = _rng(2)
    B, H, W, cin, cout = 3, 8, 8, 6, 5
    pad = k // 2
    w, b = _normal(rng, k, k, cin, cout, scale=0.3), _normal(rng, cout)
    x = _normal(rng, B, H, W, cin)
    jl, tl = None, None
    if mode != "none":
        if mode == "stacked":  # _grouped_per_row_conv on both sides
            trees = [{"m": _lora_entry(rng, (k, k, cin, r), (1, 1, r, cout), a)}
                     for r, a in ((2, 1.0), (4, 2.0), (2, 0.5))]
            jw = jax_stack_sliders([_to_jax(t) for t in trees])
        else:
            jw = _to_jax({"m": _lora_entry(rng, (k, k, cin, 4), (1, 1, 4, cout), 1.5)})
        mult = -1.3 if mode == "scalar" else np.array([-1.0, 0.5, 2.0], np.float32)
        jl, tl = _loras(jw, mult)
    ref = jb.conv2d({"weight": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x),
                    stride=stride, padding=pad, lora=jl, name="m")
    out = tb.conv2d({"weight": torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                     "bias": torch.from_numpy(b)},
                    torch.from_numpy(x), stride=stride, padding=pad, lora=tl, name="m")
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("silu", [False, True])
def test_group_norm(silu):
    rng = _rng(3)
    x = _normal(rng, 2, 4, 4, 16, scale=3.0) + 1.0
    p = {"weight": _normal(rng, 16), "bias": _normal(rng, 16)}
    ref = jb.group_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), 4,
                        eps=1e-6, silu=silu)
    out = tb.group_norm({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), 4,
                        eps=1e-6, silu=silu)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_group_norm_bf16_keeps_f32_statistics():
    """In bf16 the statistics are f32 and the normalised value is rounded to
    bf16 before the affine: the result equals the JAX package's bit for bit
    up to one bf16 rounding (2**-7 relative)."""
    rng = _rng(4)
    x = _normal(rng, 2, 4, 4, 16, scale=3.0) + 100.0  # a large mean: f32 stats matter
    p = {"weight": _normal(rng, 16), "bias": _normal(rng, 16)}
    ref = jb.group_norm({k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()},
                        jnp.asarray(x, jnp.bfloat16), 4)
    out = tb.group_norm({k: torch.from_numpy(v).bfloat16() for k, v in p.items()},
                        torch.from_numpy(x).bfloat16(), 4)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=2**-7, atol=2**-7)


def test_layer_norm():
    rng = _rng(5)
    x = _normal(rng, 2, 7, 24, scale=2.0) + 0.5
    p = {"weight": _normal(rng, 24), "bias": _normal(rng, 24)}
    ref = jb.layer_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    out = tb.layer_norm({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("dim", [32, 33, 320])
def test_timestep_embedding(dim):
    t = np.array([0.0, 1.0, 481.0, 999.0], np.float32)
    ref = jb.timestep_embedding(jnp.asarray(t), dim)
    out = tb.timestep_embedding(torch.from_numpy(t), dim)
    # sin/cos of arguments up to ~1e3 in f32: a few ulps of the argument
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["silu", "quick_gelu", "gelu"])
def test_activations(name):
    x = _normal(_rng(6), 64, scale=3.0)
    ref = jb.ACTIVATIONS[name](jnp.asarray(x))
    out = tb.ACTIVATIONS[name](torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
