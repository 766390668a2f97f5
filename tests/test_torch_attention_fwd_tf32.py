"""The error argument of #1's f32 forward on the CPU.

On the card the f32 forward (`csrc/sd_attention.cu`, `attn_fwd_tf32`) takes
two passes over K as the bf16 kernel does: pass 1 forms S = Q K^T a K tile
at a time (64 keys where d <= 64, 32 above) and keeps each row's running
max m and sum l; pass 2 forms the same S again (the same products in the
same order, so the same bits), p = 2^(c s - (c m + log2 l)) with c = scale
log2(e) (the normalised softmax in f32), and O += P V, each tile's P V
from zero and added into a running f32 sum. Every product is three TF32
products a k8 step, A_lo B_hi + A_hi B_lo + A_hi B_hi: B (K, and V
transposed) from the split pass's planes (hi = tf32_rna(x), lo =
tf32_rna(x - hi)), A (Q, and p) split in the kernel (hi = tf32_rna(x), lo
= x - hi, which the tensor cores read truncated to TF32). This file
emulates that arithmetic in torch at SD1.5's first level (L = 4096) with
d = 40 and 80, B = 1 and one head: the splits by bit rounding
(`ops/conv3x3.tf32_rna`) and truncation, each tile's three products summed
exactly (f64) and rounded to f32, the running sums in f32. It holds the
result to an f64 reference, to `sd_attention_ref` and to the JAX package's
plain path (`xla_attention`, which it runs off the TPU) within the card
tests' f32 tolerance (1e-5 of max(1, the output's largest magnitude)), and
shows that one TF32 product (A_hi B_hi) misses it.

The kernel hands p from the S accumulator to P V's A registers without a
shuffle: a TF32 A fragment holds columns (t4, t4 + 4) of each k8 block
where the accumulator holds (2 t4, 2 t4 + 1), and the split pass writes V's
transposed planes with the keys of each block of 8 in the order 0 2 4 6 1
3 5 7. `test_p_fragments_meet_the_split_pass_key_order` rebuilds the A
matrix from the accumulator elements as the kernel moves them and holds
its product with V in that order to P V exactly.

It cannot model the tensor cores' own accumulation inside a tile's chain
of products (the sums here are exact): the card tests of
`tests/test_torch_kernel_cuda.py` and `chip_smoke.py` guard that.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_tpu.ops.attention import xla_attention as jax_xla_attention
from sliders_tpu_torch.ops import sd_attention as sa
from sliders_tpu_torch.ops.conv3x3 import tf32_rna

L = 4096
TOL = 1e-5  # of max(1, the output's largest magnitude), as the card tests hold it
LOG2E = 1.4426950408889634


def _split(x: torch.Tensor) -> tuple:
    """The split pass's: both parts rounded to TF32."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def _split_in_kernel(x: torch.Tensor) -> tuple:
    """The kernel's own: lo = x - hi as the tensor cores read it, its low
    13 bits dropped."""
    hi = tf32_rna(x)
    return hi, ((x - hi).view(torch.int32) & -0x2000).view(torch.float32)


def _product(a: torch.Tensor, b: torch.Tensor, three: bool) -> torch.Tensor:
    """a @ b (f32 operands) as the kernel takes it in one tile, a split in
    the kernel and b from the planes: the TF32 products summed exactly,
    rounded to f32 once."""
    (ah, al), (bh, bl) = _split_in_kernel(a), _split(b)
    out = ah.double() @ bh.double()
    if three:
        out = out + al.double() @ bh.double() + ah.double() @ bl.double()
    return out.float()


def _forward(q, k, v, three: bool) -> torch.Tensor:
    """#1's f32 forward as the kernel computes it, for (L, d) q, k, v."""
    d = q.shape[1]
    bk = 64 if d <= 64 else 32
    c = torch.tensor(LOG2E / math.sqrt(d), dtype=torch.float32)
    s = _product(q, k.T.contiguous(), three)  # over all of d at once, the same in both passes
    m = torch.full((L,), -math.inf)
    l = torch.zeros(L)
    for t in range(0, L, bk):  # pass 1
        tile = s[:, t:t + bk]
        mn = torch.maximum(m, tile.amax(1))
        b = mn * c
        l = l * torch.exp2(m * c - b) + torch.exp2(tile * c - b[:, None]).sum(1)
        m = mn
    n = m * c + torch.log2(l)
    p = torch.exp2(s * c - n[:, None])  # pass 2: normalised, f32
    o = torch.zeros((L, d))
    for t in range(0, L, bk):
        o = o + _product(p[:, t:t + bk], v[t:t + bk], three)
    return o


@functools.lru_cache(maxsize=None)
def _case(d: int) -> dict:
    """The emulated outputs (three products and one), the f64 reference,
    `sd_attention_ref` and the JAX package's `xla_attention` at (1, 1, L,
    d)."""
    rng = np.random.default_rng(100 + d)
    q, k, v = (rng.standard_normal((L, d)).astype(np.float32) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    qd, kd, vd = (t.double() for t in (tq, tk, tv))
    return {
        "3x": _forward(tq, tk, tv, True),
        "1x": _forward(tq, tk, tv, False),
        "f64": torch.softmax((qd @ kd.T) / math.sqrt(d), dim=-1) @ vd,
        "ref": sa.sd_attention_ref(tq[None, None], tk[None, None], tv[None, None])[0, 0],
        "jax": torch.from_numpy(np.array(jax_xla_attention(
            *(jnp.asarray(t[None, None]) for t in (q, k, v))))[0, 0]),
    }


def _err(got, want) -> float:
    """The largest error as a share of the tolerance."""
    return ((got.double() - want.double()).abs().max().item()
            / (TOL * max(1.0, want.abs().max().item())))


@pytest.mark.parametrize("want", ["f64", "ref", "jax"])
@pytest.mark.parametrize("d", [40, 80])
def test_three_products_meet_the_f32_tolerance(d, want):
    """Three TF32 products a step, per-tile P V sums: within 1e-5 of the
    output's largest magnitude (1 below it), against f64, the f32 plain
    version and the JAX package's plain path (a share of the tolerance well
    under one)."""
    assert _err(_case(d)["3x"], _case(d)[want]) <= 0.5


@pytest.mark.parametrize("d", [40, 80])
def test_one_product_misses_the_f32_tolerance(d):
    """One TF32 product a step (11 bits an operand) misses the same
    tolerance: the compensation is what makes the path f32."""
    assert _err(_case(d)["1x"], _case(d)["f64"]) > 1.0


@pytest.mark.parametrize("d", [8, 40, 128, 256])
def test_p_fragments_meet_the_split_pass_key_order(d):
    """The kernel's move of p from the S accumulator into P V's A registers
    (h[0..3] = s[4 kk], s[4 kk + 2], s[4 kk + 1], s[4 kk + 3]) and the split
    pass's key order (position c of a block of 8 holds key 2 c below 4, 2
    (c - 4) + 1 above) give P V exactly, on integers so that any misplaced
    element shows. Layouts (PTX ISA, wgmma m64nNk8 with A from registers and
    its f32 accumulator; g = lane / 4, t4 = lane % 4, 16 rows a warp):
    accumulator element 4 j + e is row g + 8 (e >= 2), column 8 j + 2 t4 +
    (e & 1); A register e is row g + 8 (e & 1), column t4 + 4 (e >> 1) of
    its k8 block."""
    rng = np.random.default_rng(d)
    keys = 64
    p = torch.from_numpy(rng.integers(-8, 8, (64, keys))).double()
    v = torch.from_numpy(rng.integers(-8, 8, (keys, d))).double()
    a = torch.full((64, keys), math.nan, dtype=torch.float64)
    for warp in range(4):
        for lane in range(32):
            g, t4 = lane // 4, lane % 4
            # this thread's accumulator elements, as the kernel holds them
            acc = [p[16 * warp + g + 8 * (e >= 2), 8 * j + 2 * t4 + (e & 1)]
                   for j in range(keys // 8) for e in range(4)]
            for kk in range(keys // 8):
                regs = (acc[4 * kk], acc[4 * kk + 2], acc[4 * kk + 1], acc[4 * kk + 3])
                for e, x in enumerate(regs):
                    a[16 * warp + g + 8 * (e & 1), 8 * kk + t4 + 4 * (e >> 1)] = x
    order = [8 * (c // 8) + (2 * (c % 8) if c % 8 < 4 else 2 * (c % 8) - 7) for c in range(keys)]
    assert sorted(order) == list(range(keys))
    assert torch.equal(a @ v[order], p @ v)
