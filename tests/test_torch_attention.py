"""Parity of the port's attention with sliders_tpu on the CPU, and the SD
kernel's routing gate.

On a CPU tensor `sd_attention` runs its plain version (`sd_attention_ref`);
the TPU kernel runs in Pallas interpret mode, as tests/test_flash_attention.py
runs it. f32 inputs from a seeded numpy generator; tolerance 1e-5 (the
softmax and sums run in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_tpu.ops import attention as ja
from sliders_tpu.ops import pallas_attention as pa
from sliders_tpu_torch.ops import attention as ta
from sliders_tpu_torch.ops import sd_attention as tsa

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", [(1, 2, 1024, 40), (1, 2, 1024, 80)])
def test_sd_attention_matches_pallas_interpret(shape):
    q, k, v = _qkv(shape)
    ref = np.asarray(pa.sd_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 512, True))
    launches = tsa.sd_attention.launches
    out = tsa.sd_attention(*(torch.from_numpy(t) for t in (q, k, v)))
    assert tsa.sd_attention.launches == launches  # CPU tensors never reach the kernel
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    plain = tsa.sd_attention_ref(*(torch.from_numpy(t) for t in (q, k, v)))
    np.testing.assert_allclose(plain.numpy(), ref, **TOL)
    xla = np.asarray(ja.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(plain.numpy(), xla, **TOL)


@pytest.mark.parametrize("shape", [(2, 2, 64, 40), (1, 3, 77, 16)])
def test_xla_attention_matches(shape):
    q, k, v = _qkv(shape, seed=1)
    ref = np.asarray(ja.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    out = ta.xla_attention(*(torch.from_numpy(t) for t in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_xla_attention_bf16_keeps_f32_logits():
    """bf16 inputs: f32 logits and softmax, p rounded to bf16 before P.V, as
    in the JAX package; equal within one bf16 rounding of the output."""
    q, k, v = _qkv((1, 2, 64, 40), seed=2)
    ref = ja.xla_attention(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)))
    out = ta.xla_attention(*(torch.from_numpy(t).bfloat16() for t in (q, k, v)))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=2**-7, atol=2**-8)


@pytest.mark.parametrize(
    "lq,lkv,heads,width,masked",
    [
        (1024, 1024, 2, 80, False),  # self-attention, routed (d=40)
        (1024, 1024, 2, 160, False),  # self-attention, routed (d=80)
        (256, 77, 2, 64, False),  # cross-attention
        (64, 64, 2, 64, True),  # causal (CLIP)
    ],
)
def test_multihead_attention_matches(lq, lkv, heads, width, masked):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, lq, width)).astype(np.float32)
    k = rng.standard_normal((2, lkv, width)).astype(np.float32)
    v = rng.standard_normal((2, lkv, width)).astype(np.float32)
    jmask = ja.causal_mask(lq) if masked else None
    tmask = ta.causal_mask(lq) if masked else None
    ref = ja.multihead_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
                                 mask=jmask)
    out = ta.multihead_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 heads, mask=tmask)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize(
    "q_shape,k_shape,masked,routed",
    [
        ((16, 8, 4096, 40), (16, 8, 4096, 40), False, True),  # SD1.5 level-0 self-attention
        ((16, 8, 1024, 80), (16, 8, 1024, 80), False, True),  # SD1.5 level-1 self-attention
        ((16, 8, 256, 160), (16, 8, 256, 160), False, False),  # level 2: d=160 > 128
        ((16, 8, 64, 160), (16, 8, 64, 160), False, False),  # mid block: L=64
        ((16, 8, 4096, 40), (16, 8, 77, 40), False, False),  # cross-attention
        ((2, 12, 77, 64), (2, 12, 77, 64), True, False),  # CLIP causal
        ((8, 1, 4096, 512), (8, 1, 4096, 512), False, False),  # VAE mid attention
        ((2, 8, 8192, 40), (2, 8, 8192, 40), False, True),  # no VMEM ceiling: K/V stream
    ],
)
def test_routing_gate(q_shape, k_shape, masked, routed):
    mask = np.zeros((1, 1, q_shape[2], k_shape[2]), np.float32) if masked else None
    assert ta.routes_to_sd_kernel(q_shape, k_shape, mask) is routed


def test_sd_attention_rejects_what_the_kernel_does_not_take():
    q = torch.zeros((1, 2, 1024, 40))
    with pytest.raises(ValueError, match="head dim"):
        tsa._check(q[..., :36], q[..., :36], q[..., :36])
    with pytest.raises(ValueError, match="bf16, f16 or f32"):
        tsa._check(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="one dtype"):
        tsa._check(q.half(), q, q)
    with pytest.raises(ValueError, match="disagree"):
        tsa._check(q, q[:, :1], q[:, :1])
    d_major = q.transpose(2, 3).contiguous().transpose(2, 3)  # same shape, stride(3) != 1
    with pytest.raises(ValueError, match="strides"):
        tsa._check(d_major, q, q)
