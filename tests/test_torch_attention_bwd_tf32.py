"""The error argument of #2's and #4's f32 backwards on the CPU.

On the card the f32 backward (`csrc/attention_bwd_sm90.cuh`, its TF32 plan)
takes every product as three TF32 products a k8 step, A_lo B_hi + A_hi B_lo
+ A_hi B_hi, and sums each streamed tile's products from zero before adding
the tile's sum into a running f32 sum: S and dP over d at once, dV^T and
dK^T over 64 (d <= 48) or 32 (d > 48) q rows a tile, dQ^T over as many keys
a tile. One operand of each product comes from the split pass's planes
(hi = tf32_rna(x), lo = tf32_rna(x - hi)); the other the kernel splits
itself (the resident rows of S and dP; p and ds): hi = tf32_rna(x) and lo
= x - hi, which the tensor cores read truncated to TF32. This file
emulates that arithmetic in torch, at SD1.5's first level (L = 4096) and
d = 40, 80 and 128 with B = 1 and one head: the splits by bit rounding
(`ops/conv3x3.tf32_rna`) and truncation, each tile's three products
summed exactly (f64) and rounded to f32, the running sums in f32, p, dsum
and ds in f32 as the kernels form them. It holds the result to an f64 reference and to
`sd_attention_bwd_ref` within the card tests' f32 tolerance (1e-5 of each
output's largest magnitude), and shows that one TF32 product (A_hi B_hi)
misses it.

#4's f32 backward at d = 128 runs the same plan with #4's numeric policy
(the TPU flash kernel's `_flash_attention_bwd_dkv` and `_dq`): p = exp(s
scale - m) (1 / l) from the forward's residuals m and l, ds = ((dp - di)
p) scale with di = rowsum(o do), the scale applied before the products,
dv += p^T do, dk += ds^T q, dq = ds k, over 32-row tiles; its dq kernel
reads m, l and di and makes no statistics pass. It is emulated at FLUX's
1280 px length (L = 6912, the tiny f32 FLUX run's) and held to f64, to
`flash_attention_bwd_ref` and to `jax.vjp` of the JAX package's plain path
(`xla_attention`) in the same way.

It cannot model the tensor cores' own accumulation inside a tile's chain
of products (the sums here are exact): the card tests of
`tests/test_torch_kernel_cuda.py` and `chip_smoke.py` guard that.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_tpu.ops.attention import xla_attention as jax_xla_attention
from sliders_tpu_torch.ops import flash_attention as fa
from sliders_tpu_torch.ops import sd_attention as sa
from sliders_tpu_torch.ops.conv3x3 import tf32_rna

L = 4096
L_FLASH = 6912  # FLUX's joint attention at 1280 px: 512 + 80**2 tokens
TOL = 1e-5  # of max(1, each output's largest magnitude), as the card tests hold it


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


def _tiled(a: torch.Tensor, b: torch.Tensor, rows: int, three: bool) -> torch.Tensor:
    """a @ b contracted over `rows`-long tiles of the inner dim, each tile's
    products from zero, the tiles' sums added in order into an f32 sum."""
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for t in range(0, a.shape[1], rows):
        acc = acc + _product(a[:, t:t + rows], b[t:t + rows], three)
    return acc


@functools.lru_cache(maxsize=None)
def _case(d: int) -> dict:
    """The emulated outputs (three products and one), the f64 reference and
    `sd_attention_bwd_ref` at (1, 1, L, d)."""
    rng = np.random.default_rng(d)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((L, d)).astype(np.float32))
                  for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    bn = 64 if d <= 48 else 32
    out = {}
    for name, three in (("3x", True), ("1x", False)):
        s = _product(q, k.T.contiguous(), three)  # over all of d at once
        dp = _product(g, v.T.contiguous(), three)
        p = torch.softmax(s * scale, dim=-1)
        dsum = (dp * p).sum(-1, keepdim=True)
        ds = p * (dp - dsum)
        dv = _tiled(p.T.contiguous(), g, bn, three)  # dV^T = dO^T P over q tiles
        dk = _tiled(ds.T.contiguous(), q, bn, three) * scale
        dq = _tiled(ds, k, bn, three) * scale  # dQ^T = K^T dS^T over key tiles
        out[name] = (dq, dk, dv)
    qd, kd, vd, gd = (t.double() for t in (q, k, v, g))
    p = torch.softmax((qd @ kd.T) * scale, dim=-1)
    dp = gd @ vd.T
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    out["f64"] = (ds @ kd * scale, ds.T @ qd * scale, p.T @ gd)
    ref = sa.sd_attention_bwd_ref(*(t[None, None] for t in (q, k, v, g)))
    out["ref"] = tuple(t[0, 0] for t in ref)
    return out


@functools.lru_cache(maxsize=None)
def _flash_case(d: int) -> dict:
    """#4's policy emulated (three products and one), the f64 reference,
    `flash_attention_bwd_ref` (from the plain forward's o, m, l) and jax.vjp
    of `xla_attention` at (1, 1, L_FLASH, d)."""
    rng = np.random.default_rng(200 + d)
    q, k, v, g = (rng.standard_normal((L_FLASH, d)).astype(np.float32) for _ in range(4))
    tq, tk, tv, tg = (torch.from_numpy(t) for t in (q, k, v, g))
    scale = d ** -0.5
    o, m, l = fa.flash_attention_fwd_ref(*(t[None, None] for t in (tq, tk, tv)))
    o, m, l = o[0, 0], m[0, 0], l[0, 0]
    di = (o * tg).sum(-1, keepdim=True)
    out = {}
    for name, three in (("3x", True), ("1x", False)):
        s = _product(tq, tk.T.contiguous(), three)
        dp = _product(tg, tv.T.contiguous(), three)
        p = torch.exp(s * scale - m[:, None]) * (1.0 / l)[:, None]
        ds = ((dp - di) * p) * scale
        del s, dp
        out[name] = (_tiled(ds, tk, 32, three), _tiled(ds.T.contiguous(), tq, 32, three),
                     _tiled(p.T.contiguous(), tg, 32, three))
        del p, ds
    qd, kd, vd, gd = (t.double() for t in (tq, tk, tv, tg))
    p = torch.softmax((qd @ kd.T) * scale, dim=-1)
    dp = gd @ vd.T
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    out["f64"] = (ds @ kd, ds.T @ qd, p.T @ gd)
    del p, dp, ds
    ref = fa.flash_attention_bwd_ref(*(t[None, None] for t in (tq, tk, tv, o, tg, m, l)))
    out["ref"] = tuple(t[0, 0] for t in ref)
    _, vjp = jax.vjp(jax_xla_attention, *(jnp.asarray(t[None, None]) for t in (q, k, v)))
    out["jax"] = tuple(torch.from_numpy(np.array(t)[0, 0]) for t in vjp(jnp.asarray(g[None, None])))
    return out


def _err(got, want) -> float:
    """The largest error over dq, dk, dv, each as a share of its tolerance."""
    return max((a.double() - b.double()).abs().max().item()
               / (TOL * max(1.0, b.abs().max().item())) for a, b in zip(got, want))


@pytest.mark.parametrize("d", [40, 80, 128])
def test_three_products_meet_the_f32_tolerance(d):
    """Three TF32 products a step, per-tile sums: within 1e-5 of each
    output's largest magnitude, against f64 and against the f32 plain
    version (a share of the tolerance well under one)."""
    case = _case(d)
    assert _err(case["3x"], case["f64"]) <= 0.5
    assert _err(case["3x"], case["ref"]) <= 0.5


@pytest.mark.parametrize("d", [40, 80, 128])
def test_one_product_misses_the_f32_tolerance(d):
    """One TF32 product a step (11 bits an operand) misses the same
    tolerance by far: the compensation is what makes the path f32."""
    assert _err(_case(d)["1x"], _case(d)["f64"]) > 10.0


@pytest.mark.parametrize("want", ["f64", "ref", "jax"])
def test_flash_policy_three_products_meet_the_f32_tolerance(want):
    """#4's f32 backward at d = 128 on the TF32 plan, with #4's policy: dq,
    dk and dv within 1e-5 of each output's largest magnitude against f64,
    the plain version and the JAX package's plain path."""
    assert _err(_flash_case(128)["3x"], _flash_case(128)[want]) <= 0.5


def test_flash_policy_one_product_misses_the_f32_tolerance():
    """One TF32 product a step misses the tolerance under #4's policy too
    (by about ten times)."""
    assert _err(_flash_case(128)["1x"], _flash_case(128)["f64"]) > 1.0
