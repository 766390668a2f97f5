"""The attention backward on the CPU, against sliders_tpu: the backward
kernel's plain version against the TPU backward kernel in Pallas interpret
mode, the autograd path of the routed attention against jax.vjp of the JAX
multihead attention, and the routing of the grad path.

Inputs come from a seeded numpy generator. f32 is held to 1e-5 (sums in
another order); bf16 to one bf16 ulp at each output's largest magnitude
(both sides round p and ds at the same points, so an element may differ by
one rounding).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_tpu.ops import attention as ja
from sliders_tpu.ops import pallas_attention as pa
from sliders_tpu_torch.ops import attention as ta
from sliders_tpu_torch.ops import sd_attention as tsa

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _arrays(shape, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 2, 256, 40), (1, 2, 256, 80)])
def test_bwd_ref_matches_pallas_interpret(shape, dtype):
    jdt, tdt = DTYPES[dtype]
    q, k, v, g = _arrays(shape, 4)
    ref = pa._sd_attention_bwd_impl(*(jnp.asarray(x, jdt) for x in (q, k, v, g)), True)
    launches = tsa.sd_attention_bwd.launches
    out = tsa.sd_attention_bwd(*(torch.from_numpy(x).to(tdt) for x in (q, k, v, g)))
    assert tsa.sd_attention_bwd.launches == launches  # CPU tensors never reach the kernel
    for o, r in zip(out, ref):
        r = np.asarray(r, np.float32)
        assert o.dtype == tdt and o.shape == shape
        ref_max = np.abs(r).max()
        tol = 1e-5 if dtype == "float32" else 2.0 ** (math.floor(math.log2(ref_max)) - 7)
        np.testing.assert_allclose(o.float().numpy(), r, rtol=0, atol=tol)


@pytest.mark.parametrize("heads,width", [(2, 80), (2, 160)])
def test_routed_attention_grads_match_jax_vjp(heads, width):
    """L=1024 self-attention (routed: d=40 and d=80) under grad on the CPU:
    the SdAttention path's grads equal jax.vjp of the JAX multihead
    attention's plain path."""
    q, k, v, g = _arrays((2, 1024, width), 4, seed=1)
    assert ta.routes_to_sd_kernel((2, heads, 1024, width // heads),
                                  (2, heads, 1024, width // heads), None)
    _, vjp = jax.vjp(lambda a, b, c: ja.multihead_attention(a, b, c, heads),
                     *(jnp.asarray(x) for x in (q, k, v)))
    ref = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ta.multihead_attention(*leaves, heads)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for a, b in zip(grads, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_grad_path_carries_grad_fn_and_serving_path_does_not():
    """The repaired fault, on the CPU: inputs that require grad give an
    output with a grad_fn through SdAttention; under no_grad the call stays
    the plain forward with no graph, as serving runs it."""
    q, k, v = (torch.from_numpy(x) for x in _arrays((1, 2, 1024, 40), 3, seed=2))
    out = tsa.sd_attention(q.requires_grad_(), k, v)
    assert type(out.grad_fn).__name__ == "SdAttentionBackward"
    with torch.no_grad():
        assert tsa.sd_attention(q, k, v).grad_fn is None
    with torch.inference_mode():
        assert tsa.sd_attention(q.detach(), k, v).grad_fn is None
    np.testing.assert_array_equal(out.detach().numpy(),
                                  tsa.sd_attention_ref(q.detach(), k, v).numpy())


def test_grads_flow_to_every_input():
    """dq, dk and dv all reach their leaves (the attn1 to_q/to_k/to_v LoRA
    factors sit behind them) and equal the plain backward's formula."""
    q, k, v, g = (torch.from_numpy(x) for x in _arrays((1, 2, 1024, 40), 4, seed=3))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    (tsa.sd_attention(*leaves) * g).sum().backward()
    for leaf, ref in zip(leaves, tsa.sd_attention_bwd_ref(q, k, v, g)):
        assert leaf.grad is not None
        np.testing.assert_allclose(leaf.grad.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "q_shape,k_shape,masked",
    [
        ((1, 8, 4096, 40), (1, 8, 4096, 40), False),  # SD1.5 grad pass, level 0
        ((1, 8, 1024, 80), (1, 8, 1024, 80), False),  # SD1.5 grad pass, level 1
        ((1, 24, 4096, 128), (1, 24, 4096, 128), False),  # FLUX head dim
        ((1, 8, 4096, 40), (1, 8, 77, 40), False),  # cross-attention
        ((2, 12, 77, 64), (2, 12, 77, 64), True),  # CLIP causal
    ],
)
def test_bwd_gate_is_the_forward_gate(q_shape, k_shape, masked):
    """No H100 measurement backs the JAX package's d >= 96 threshold, so the
    backward routes wherever the forward does (see ops/attention.py)."""
    mask = np.zeros((1, 1, q_shape[2], k_shape[2]), np.float32) if masked else None
    assert ta.routes_to_sd_bwd_kernel(q_shape, k_shape, mask) == \
        ta.routes_to_sd_kernel(q_shape, k_shape, mask)


@pytest.mark.parametrize("impl,routed", [("auto", True), ("pallas", True), ("xla", False)])
def test_attention_impl_picks_the_route(monkeypatch, impl, routed):
    """config.tpu.attention: 'auto'/'pallas' take the kernel route where the
    gate allows, 'xla' the plain path everywhere."""
    calls = []
    monkeypatch.setattr(ta, "sd_attention", lambda *a, **kw: calls.append(1) or
                        tsa.sd_attention_ref(*a))
    x = torch.from_numpy(_arrays((1, 1024, 80), 1, seed=4)[0])
    ta.set_attention_impl(impl)
    try:
        out = ta.multihead_attention(x, x, x, 2)
    finally:
        ta.set_attention_impl("auto")
    assert bool(calls) is routed
    ref = ja.multihead_attention(*(jnp.asarray(x.numpy()),) * 3, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_attention_impl_rejects_unknown():
    with pytest.raises(ValueError, match="auto"):
        ta.set_attention_impl("flash")
    assert ta._impl == "auto"
