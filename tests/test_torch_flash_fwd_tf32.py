"""The error argument of #4's f32 forward on the CPU, and its plans.

On the card #4's f32 forward at d = 128 and 256 (`csrc/attention_fwd_tf32.cuh`,
plans FWD_ONE_PASS and FWD_SPLIT_D) takes one pass over K in 32-key tiles
with #4's online softmax: per tile S = Q K^T (unscaled), m' = max(m, rowmax
s), b' = c m' in f32 with c = scale log2(e), p = 2^(c s - b') unnormalised,
a = 2^(b - b'), l = l a + rowsum p, and O = O a + P V with each tile's P V
from zero; o = O / l at the end, and the residuals m = scale m and l. Every
product is three TF32 products a k8 step, A_lo B_hi + A_hi B_lo + A_hi B_hi:
B (K, and V transposed) from the split pass's planes (hi = tf32_rna(x), lo
= tf32_rna(x - hi)), A (Q, and p) split in the kernel (hi = tf32_rna(x), lo
= x - hi, which the tensor cores read truncated to TF32). At d = 256 the two
consumer warpgroups each form S over their 128 columns of d and add the
other's partial tile to their own, so S is the f32 sum of two partials.

This file emulates that arithmetic in torch at B = H = 1, L = 2048, d = 128
and 256: the splits by bit rounding (`ops/conv3x3.tf32_rna`) and truncation,
each product of each tile summed exactly (f64) and rounded to f32, the
partials added in f32, the running sums in f32. It
holds o to an f64 reference, to `flash_attention_fwd_ref` and to the JAX
package's plain path (`xla_attention`, which it runs off the TPU) within the
card tests' f32 tolerance (1e-5 of max(1, the output's largest magnitude)),
m and l to `flash_attention_fwd_ref`'s within 1e-5 relative, and shows
that one TF32 product (A_hi B_hi) misses the tolerance and that the fused
rescale 2^(c m - b') would let l drift past it over 6912 keys.

It cannot model the tensor cores' own accumulation inside a tile's chain of
products (the sums here are exact), nor ex2.approx: the card tests of
`tests/test_torch_kernel_cuda.py` and `chip_smoke.py` guard those.

It also holds `ops/flash_attention.fwd_plan`, the plan each (dtype, head dim)
launches on the card, to the head dims the wrapper takes and the shapes the
models route to #4.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_tpu.ops.attention import xla_attention as jax_xla_attention
from sliders_tpu_torch.ops import attention as ta
from sliders_tpu_torch.ops import flash_attention as fa
from sliders_tpu_torch.ops.conv3x3 import tf32_rna

L = 2048
BK = 32  # keys a tile, as the kernel's stages hold them
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


def _exp2(x: torch.Tensor, c: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """2^(x c - b) with x c - b rounded once to f32, as ex2(fmaf(x, c, -b))."""
    return torch.exp2((x.double() * c.double() - b.double()).float())


def _forward(q, k, v, three: bool) -> tuple:
    """#4's f32 forward as the kernel computes it, for (L, d) q, k, v: (o,
    m, l)."""
    d = q.shape[1]
    scale = torch.tensor(1 / math.sqrt(d), dtype=torch.float32)
    c = torch.tensor(LOG2E / math.sqrt(d), dtype=torch.float32)
    # the columns of d each consumer warpgroup contracts for S
    halves = (slice(0, d // 2), slice(d // 2, d)) if d == 256 else (slice(None),)
    m = torch.full((L,), -math.inf)
    b = torch.full((L,), -math.inf)
    l = torch.zeros(L)
    o = torch.zeros((L, d))
    for t in range(0, L, BK):
        kt, vt = k[t:t + BK], v[t:t + BK]
        parts = [_product(q[:, h].contiguous(), kt[:, h].T.contiguous(), three) for h in halves]
        s = parts[0] if len(parts) == 1 else parts[0] + parts[1]  # f32, commutative
        mn = torch.maximum(m, s.amax(1))
        bn = mn * c
        a = torch.exp2(b - bn)  # exactly 1 where the max holds, 0 on the first tile
        p = _exp2(s, c, bn[:, None])
        l = l * a + p.sum(1)
        m, b = mn, bn
        o = o * a[:, None] + _product(p, vt, three)
    return o / l[:, None], m * scale, l


@functools.lru_cache(maxsize=None)
def _case(d: int) -> dict:
    """The emulated outputs (three products and one), the f64 reference,
    `flash_attention_fwd_ref` and the JAX package's `xla_attention` at (1, 1,
    L, d)."""
    rng = np.random.default_rng(200 + d)
    q, k, v = (rng.standard_normal((L, d)).astype(np.float32) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    qd, kd, vd = (t.double() for t in (tq, tk, tv))
    ro, rm, rl = fa.flash_attention_fwd_ref(tq[None, None], tk[None, None], tv[None, None])
    return {
        "3x": _forward(tq, tk, tv, True),
        "1x": _forward(tq, tk, tv, False),
        "f64": torch.softmax((qd @ kd.T) / math.sqrt(d), dim=-1) @ vd,
        "ref": (ro[0, 0], rm[0, 0], rl[0, 0]),
        "jax": torch.from_numpy(np.array(jax_xla_attention(
            *(jnp.asarray(t[None, None]) for t in (q, k, v))))[0, 0]),
    }


def _err(got, want) -> float:
    """The largest error as a share of the tolerance."""
    return ((got.double() - want.double()).abs().max().item()
            / (TOL * max(1.0, want.abs().max().item())))


@pytest.mark.parametrize("want", ["f64", "ref", "jax"])
@pytest.mark.parametrize("d", [128, 256])
def test_three_products_meet_the_f32_tolerance(d, want):
    """Three TF32 products a step, per-tile P V sums, the online rescale in
    f32: o within 1e-5 of the output's largest magnitude (1 below it),
    against f64, #4's f32 plain version and the JAX package's plain path (a
    share of the tolerance well under one)."""
    case = _case(d)
    ref = case[want][0] if want == "ref" else case[want]
    assert _err(case["3x"][0], ref) <= 0.5


@pytest.mark.parametrize("d", [128, 256])
def test_residuals_meet_the_plain_forward(d):
    """m (scaled) and l, which #4's f32 backward reads, within 1e-5 relative
    of `flash_attention_fwd_ref`'s, as the card tests hold the kernel's."""
    _, m, l = _case(d)["3x"]
    _, rm, rl = _case(d)["ref"]
    for a, b in ((m, rm), (l, rl)):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


@pytest.mark.parametrize("d", [128, 256])
def test_one_product_misses_the_f32_tolerance(d):
    """One TF32 product a step (11 bits an operand) misses the same
    tolerance: the compensation is what makes the path f32."""
    assert _err(_case(d)["1x"][0], _case(d)["f64"]) > 1.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [128, 256, 384, 512, 640, 1024])
def test_fwd_plan_maps_every_head_dim_the_wrapper_takes(dtype, d):
    """The wrapper's shape gate takes every multiple of 128, as the routing
    gate's shape test (`fa_supports`) does; `fwd_plan` names the kernel plan
    of bf16 d = 128 and 256 ("sm90"), f32 d = 128 and 256 ("tf32") and f32
    d = 512 ("d512"), and refuses every other head dim, so a CUDA call there
    raises before any launch instead of reaching a plain version."""
    q = torch.zeros((1, 1, 128, d), dtype=dtype)
    fa._check(q, q, q)
    assert ta.fa_supports((1, 1, 1024, d), (1, 1, 1024, d))
    want = {(torch.bfloat16, 128): "sm90", (torch.bfloat16, 256): "sm90",
            (torch.float32, 128): "tf32", (torch.float32, 256): "tf32",
            (torch.float32, 512): "d512"}.get((dtype, d))
    if want is None:
        with pytest.raises(ValueError, match="flash_attention's kernels take"):
            fa.fwd_plan(dtype, d)
    else:
        assert fa.fwd_plan(dtype, d) == want
    assert set(fa.flash_attention.launches_by_plan) == set(fa.FWD_PLANS)


@pytest.mark.parametrize("shape,dtype,plan", [
    ((1, 24, 16896, 128), torch.bfloat16, "sm90"),  # FLUX's joint attention at 2048 px
    ((1, 24, 9728, 128), torch.float32, "tf32"),    # FLUX in f32 at 1536 px
    ((1, 24, 6912, 128), torch.float32, "tf32"),    # the tiny f32 FLUX run at 1280 px
    ((8, 1, 16384, 512), torch.float32, "d512"),    # the VAE's mid attention at 1024 px
    ((8, 1, 4096, 512), torch.float32, "d512"),     # SD1.5's decode at 512 px
])
def test_routed_model_shapes_have_a_forward_plan(shape, dtype, plan):
    """Every shape a model of the repository routes to #4 has a plan."""
    itemsize = torch.finfo(dtype).bits // 8
    assert ta.routes_to_flash_kernel(shape, shape, None, itemsize)
    assert fa.fwd_plan(dtype, shape[3]) == plan


def test_rescale_is_exactly_one_while_the_max_holds():
    """The kernel rescales the running sums by a = 2^(b - b') of the f32
    exponents b = c m the p's were taken against: exactly 1 where the max
    holds, so l over 6912 keys (216 tiles, the tiny f32 FLUX run's rows)
    stays within 1e-5 relative of the f64 sum. The fused form 2^(c m - b'),
    c m exact inside the FMA, is 1 plus the rounding of b' for most maxima,
    a factor l takes again every tile, and misses that limit. (The card test
    `test_flash_bwd_kernel_matches_plain` holds the kernel's own l there.)"""
    lq, lk, d = 256, 6912, 128
    rng = np.random.default_rng(lk)
    q, k = (torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)) for n in (lq, lk))
    c = torch.tensor(LOG2E / math.sqrt(d), dtype=torch.float32)
    m = torch.full((lq,), -math.inf)
    b = torch.full((lq,), -math.inf)
    exact, fused = torch.zeros(lq), torch.zeros(lq)
    for t in range(0, lk, BK):
        s = _product(q, k[t:t + BK].T.contiguous(), True)
        mn = torch.maximum(m, s.amax(1))
        bn = mn * c
        a = torch.exp2(b - bn)
        assert torch.equal(a[mn == m], torch.ones_like(a[mn == m]))
        p = _exp2(s, c, bn[:, None]).sum(1)
        exact = exact * a + p
        fused = fused * _exp2(m, c, bn) + p
        m, b = mn, bn
    sd = q.double() @ k.double().T
    want = torch.exp((sd - sd.amax(1, keepdim=True)) / math.sqrt(d)).sum(1)

    def err(l):
        return (l.double() - want).abs().max().item() / want.abs().max().item()

    assert err(exact) <= 1e-5 / 4
    assert err(fused) > 1e-5
