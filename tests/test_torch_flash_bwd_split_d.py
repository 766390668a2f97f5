"""The error argument of #4's f32 backward at d = 256 and 512 on the CPU.

On the card (`csrc/attention_bwd_sm90.cuh`, CLUSTER in its note) the f32
backward at d = 256 and 512 runs the TF32 plan on a cluster of d / 128
blocks that split d. Block r holds columns [128 r, 128 r + 128) of the
resident rows and streams the same columns of each tile (32 rows at d =
256, 16 at d = 512). It forms its partial S^T and dP^T (the dq kernel: S
and dP) over those columns, three TF32 products a k8 step from zero, and
the blocks add the partials in rank order, so every block holds the same
sums. Each block's transposed products (dV^T = dO^T P, dK^T = Q^T dS,
dQ^T = K^T dS^T) then run over its own columns, each streamed tile's
products from zero and added into a running f32 sum. The dk/dv kernel
splits K and V itself and reads Q and dO from the split pass's planes; the
dq kernel splits Q and dO and reads K and V from the planes, so the two
kernels' p differ in the last bits, as on the card.

This file emulates that schedule with #4's numeric policy (p = exp(s scale
- m) (1 / l) from the forward's residuals, ds = ((dp - di) p) scale) at L =
2048, d = 256 and at L = 1024, d = 512, with the splits and tile sums of
`tests/test_torch_attention_bwd_tf32.py`. It holds the result to f64, to
`flash_attention_bwd_ref` and (d = 256) to `jax.vjp` of the JAX package's
`flash_attention`, the stock TPU kernel run in interpret mode as the JAX
package's tests run it, within the card tests' f32 tolerance (1e-5 of each
output's largest magnitude), and shows that one TF32 product misses it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_tpu.ops import flash_attention as jax_flash
from sliders_tpu_torch.ops import flash_attention as fa
from test_torch_attention_bwd_tf32 import TOL, _err, _product, _tiled

COLS = 128  # a block's columns of d
BN = {256: 32, 512: 16}  # rows of a streamed tile at each head dim


def _cluster(a: torch.Tensor, b: torch.Tensor, three: bool) -> torch.Tensor:
    """a @ b (a split in the kernel, b from the planes) as the cluster forms
    it: each block's partial over its 128 columns of the inner dim, then the
    partials added in rank order in f32."""
    total = None
    for c in range(0, a.shape[1], COLS):
        part = _product(a[:, c:c + COLS], b[c:c + COLS], three)
        total = part if total is None else total + part
    return total


@functools.lru_cache(maxsize=None)
def _case(L: int, d: int, with_jax: bool) -> dict:
    """The emulated (dq, dk, dv) (three products and one), the f64
    reference, `flash_attention_bwd_ref` and, `with_jax`, jax.vjp of the
    stock kernel in interpret mode, at (1, 1, L, d)."""
    rng = np.random.default_rng(300 + d)
    q, k, v, g = (rng.standard_normal((L, d)).astype(np.float32) for _ in range(4))
    tq, tk, tv, tg = (torch.from_numpy(t) for t in (q, k, v, g))
    scale = d ** -0.5
    o, m, l = fa.flash_attention_fwd_ref(*(t[None, None] for t in (tq, tk, tv)))
    o, m, l = o[0, 0], m[0, 0], l[0, 0]
    di = (o * tg).sum(-1)
    inv = 1.0 / l
    out = {}
    for name, three in (("3x", True), ("1x", False)):
        # the dk/dv kernel: S^T = K Q^T, dP^T = V dO^T (K and V split in the kernel)
        st = _cluster(tk, tq.T.contiguous(), three)
        dpt = _cluster(tv, tg.T.contiguous(), three)
        pt = torch.exp(st * scale - m[None]) * inv[None]
        dst = ((dpt - di[None]) * pt) * scale
        del st, dpt
        dv = _tiled(pt, tg, BN[d], three)  # dV^T = dO^T P over tiles of q rows
        dk = _tiled(dst, tq, BN[d], three)  # dK^T = Q^T dS
        del pt, dst
        # the dq kernel: S = Q K^T, dP = dO V^T (Q and dO split in the kernel)
        s = _cluster(tq, tk.T.contiguous(), three)
        dp = _cluster(tg, tv.T.contiguous(), three)
        p = torch.exp(s * scale - m[:, None]) * inv[:, None]
        ds = ((dp - di[:, None]) * p) * scale
        del s, dp, p
        out[name] = (_tiled(ds, tk, BN[d], three), dk, dv)  # dQ^T = K^T dS^T over key tiles
        del ds
    qd, kd, vd, gd = (t.double() for t in (tq, tk, tv, tg))
    p = torch.softmax((qd @ kd.T) * scale, dim=-1)
    dp = gd @ vd.T
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    out["f64"] = (ds @ kd, ds.T @ qd, p.T @ gd)
    del p, dp, ds
    ref = fa.flash_attention_bwd_ref(*(t[None, None] for t in (tq, tk, tv, o, tg, m, l)))
    out["ref"] = tuple(t[0, 0] for t in ref)
    if with_jax:
        from jax.experimental.pallas import tpu as pltpu

        with pltpu.force_tpu_interpret_mode():
            _, vjp = jax.vjp(jax_flash.flash_attention,
                             *(jnp.asarray(t[None, None]) for t in (q, k, v)))
            want = vjp(jnp.asarray(g[None, None]))
        out["jax"] = tuple(torch.from_numpy(np.array(t)[0, 0]) for t in want)
    return out


@pytest.mark.parametrize("want", ["f64", "ref", "jax"])
def test_cluster_schedule_meets_the_f32_tolerance_at_d256(want):
    """d = 256, two blocks' partials: dq, dk and dv within 1e-5 of each
    output's largest magnitude against f64, the plain version and the JAX
    package's stock kernel."""
    assert _err(_case(2048, 256, True)["3x"], _case(2048, 256, True)[want]) <= 0.5


@pytest.mark.parametrize("want", ["f64", "ref"])
def test_cluster_schedule_meets_the_f32_tolerance_at_d512(want):
    """d = 512 (the VAE's head dim), four blocks' partials in rank order:
    within the same tolerance of f64 and of the plain version."""
    assert _err(_case(1024, 512, False)["3x"], _case(1024, 512, False)[want]) <= 0.5


def test_cluster_schedule_one_product_misses_the_f32_tolerance():
    """One TF32 product a step misses the tolerance on the cluster's
    schedule too: the compensation is what makes the path f32."""
    assert _err(_case(2048, 256, True)["1x"], _case(2048, 256, True)["f64"]) > 1.0


def test_partials_in_rank_order_are_one_sum_for_every_block():
    """Every block adds the same partials in the same order, so all hold the
    same bits; adding them in another order changes the last bits of some
    elements (the order is part of the result)."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((64, 512)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((512, 16)).astype(np.float32))
    parts = [_product(a[:, c:c + COLS], b[c:c + COLS], True) for c in range(0, 512, COLS)]
    in_order = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert torch.equal(_cluster(a, b, True), in_order)
    reversed_order = ((parts[3] + parts[2]) + parts[1]) + parts[0]
    assert not torch.equal(in_order, reversed_order)
    assert (in_order - reversed_order).abs().max().item() <= TOL * in_order.abs().max().item()


@pytest.mark.parametrize("dtype,d,plan", [(torch.bfloat16, 128, "pair"),
                                          (torch.bfloat16, 256, "split"),
                                          (torch.float32, 128, "tf32"),
                                          (torch.float32, 256, "cluster"),
                                          (torch.float32, 512, "cluster")])
def test_bwd_plan_of_every_head_dim_the_backward_takes(dtype, d, plan):
    """The backward's plan at each (dtype, d) it takes: f32 d = 256 and 512
    on the cluster plan, no FMA kernel left."""
    assert fa.bwd_plan(dtype, d) == plan
    assert plan in fa.BWD_PLANS


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 512), (torch.float32, 384),
                                     (torch.float16, 128)])
def test_bwd_plan_refuses_other_head_dims(dtype, d):
    with pytest.raises(ValueError, match="flash_attention_bwd's kernels take"):
        fa.bwd_plan(dtype, d)


def test_bwd_scratch_holds_the_split_planes_at_every_f32_head_dim():
    """The wrapper's scratch: di, m log2(e) and 1 / l, then (f32) the hi and
    lo planes of the two streamed tensors at the longer of Lq and Lk."""
    for d in (128, 256, 512):
        q = torch.empty((2, 3, 1024, d))
        k = torch.empty((2, 3, 2048, d))
        assert fa._bwd_scratch_floats(q, k) == 3 * 2 * 3 * 1024 + 4 * 2 * 3 * 2048 * d
    q = torch.empty((2, 3, 1024, 256), dtype=torch.bfloat16)
    assert fa._bwd_scratch_floats(q, q) == 3 * 2 * 3 * 1024
