"""The port's GroupNorm kernel #8 (`ops/group_norm.py`) and the GN fold of
the fused conv (`ops/basic.group_norm_affine`) on the CPU, against the JAX
package.

On CPU tensors `fused_group_norm` runs its plain version; the JAX side runs
its Pallas kernel in interpret mode. The same seeded numpy inputs go to
both. Tolerances, relative to the largest magnitude of the JAX result: f32
1e-5 (f32 sums in another order; var = E[x^2] - mean^2 loses a few bits to
cancellation at a mean of 0.5); bf16 two bf16 ulps (a and b are rounded to
bf16 from f32 statistics that may differ in the last bit, which can flip
one rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_tpu.ops import basic as jb
from sliders_tpu.ops import pallas_groupnorm as pg
from sliders_tpu_torch.ops import basic as tb
from sliders_tpu_torch.ops import group_norm as tg

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape,groups,eps", [((2, 64, 128), 32, 1e-5), ((1, 256, 96), 8, 1e-6)])
def test_plain_version_matches_jax_kernel(shape, groups, eps, silu, dtype):
    rng = np.random.default_rng(0)
    x = _normal(rng, *shape, scale=2.0) + 0.5
    c = shape[-1]
    gamma, beta = 1.0 + _normal(rng, c, scale=0.2), _normal(rng, c, scale=0.3)
    jd, td = DTYPES[dtype]
    assert pg.supports(shape, groups)
    ref = pg.fused_group_norm(jnp.asarray(x, jd), jnp.asarray(gamma), jnp.asarray(beta), groups,
                              eps, silu, True)
    out = tg.fused_group_norm(torch.from_numpy(x).to(td), torch.from_numpy(gamma),
                              torch.from_numpy(beta), groups, eps, silu)
    assert out.dtype == td and tuple(out.shape) == shape
    ref32 = np.asarray(ref.astype(jnp.float32))
    scale = max(1.0, float(np.abs(ref32).max()))
    tol = 1e-5 * scale if dtype == "float32" else 2 * 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert np.abs(out.float().numpy() - ref32).max() <= tol


def test_wrapper_refuses_bad_shapes():
    x = torch.zeros((1, 16, 96))
    with pytest.raises(ValueError, match="multiple of 64"):
        tg.fused_group_norm(x, torch.ones(96), torch.zeros(96), 64)
    with pytest.raises(ValueError, match="gamma"):
        tg.fused_group_norm(x, torch.ones(95), torch.zeros(96), 8)
    with pytest.raises(ValueError, match=r"\(B, L, C\)"):
        tg.fused_group_norm(torch.zeros((1, 4, 4, 96)), torch.ones(96), torch.zeros(96), 8)


@pytest.mark.parametrize("groups,eps", [(32, 1e-5), (8, 1e-6)])
def test_group_norm_affine_matches_jax(groups, eps):
    """The f32 (B, C) fold a = rstd * gamma, s = beta - mean * rstd * gamma,
    and x * a + s reproduces the plain GroupNorm."""
    rng = np.random.default_rng(1)
    x = _normal(rng, 2, 8, 16, 128, scale=3.0) + 1.0
    p = {"weight": 1.0 + _normal(rng, 128, scale=0.2), "bias": _normal(rng, 128, scale=0.3)}
    ja, js = jb.group_norm_affine({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                  groups, eps)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    ta, ts = tb.group_norm_affine(tp, torch.from_numpy(x), groups, eps)
    assert ta.dtype == ts.dtype == torch.float32 and tuple(ta.shape) == (2, 128)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    folded = torch.from_numpy(x) * ta[:, None, None, :] + ts[:, None, None, :]
    plain = tb.group_norm(tp, torch.from_numpy(x), groups, eps)
    np.testing.assert_allclose(folded.numpy(), plain.numpy(), rtol=0, atol=1e-5)


def test_group_norm_affine_bf16_input_keeps_f32_fold():
    """A bf16 activation still gives f32 a and s (the fused kernel takes
    them in f32), from f32 statistics."""
    rng = np.random.default_rng(2)
    x = _normal(rng, 1, 4, 8, 64, scale=2.0) + 50.0
    p = {"weight": _normal(rng, 64), "bias": _normal(rng, 64)}
    ja, js = jb.group_norm_affine({k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()},
                                  jnp.asarray(x, jnp.bfloat16), 32)
    ta, ts = tb.group_norm_affine({k: torch.from_numpy(v).bfloat16() for k, v in p.items()},
                                  torch.from_numpy(x).bfloat16(), 32)
    assert ta.dtype == ts.dtype == torch.float32
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja, np.float32), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js, np.float32), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,silu", [((2, 4096, 320), True), ((2, 1024, 1280), False)])
def test_kernel_summation_order_matches_jax_kernel(shape, silu, dtype):
    """The card kernel's order of the f32 sums (`fused_group_norm_chunked`:
    each thread's per-channel sums over its rows of a chunk, the block's
    fold over its row threads and the group's channels, the chunks' partials
    in order) at the UNet's level-0 and level-1 widths: against the JAX
    kernel in interpret mode and the plain version, within the tolerances
    above."""
    rng = np.random.default_rng(2)
    x = _normal(rng, *shape, scale=2.0) + 0.5
    c = shape[-1]
    gamma, beta = 1.0 + _normal(rng, c, scale=0.2), _normal(rng, c, scale=0.3)
    jd, td = DTYPES[dtype]
    tx, tgm, tbt = torch.from_numpy(x).to(td), torch.from_numpy(gamma), torch.from_numpy(beta)
    out = tg.fused_group_norm_chunked(tx, tgm, tbt, 32, 1e-5, silu)
    assert out.dtype == td and tuple(out.shape) == shape
    jax_out = np.asarray(pg.fused_group_norm(jnp.asarray(x, jd), jnp.asarray(gamma),
                                             jnp.asarray(beta), 32, 1e-5, silu, True)
                         .astype(jnp.float32))
    plain = tg.fused_group_norm_ref(tx, tgm, tbt, 32, 1e-5, silu).float().numpy()
    for want in (jax_out, plain):
        scale = max(1.0, float(np.abs(want).max()))
        tol = 1e-5 * scale if dtype == "float32" else 2 * 2.0 ** (np.floor(np.log2(scale)) - 7)
        assert np.abs(out.float().numpy() - want).max() <= tol


@pytest.mark.parametrize("L,C", [(4096, 320), (4096, 960), (1024, 1280), (256, 2560),
                                 (64, 1280), (1000, 96)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_plan_covers_every_row_once(L, C, dtype):
    """The plan at the UNet's shapes (batch 16): a block's C / V * rpi
    threads fit one block, its chunks cover the L rows once, and a pass has
    about four blocks an SM (fewer where a thread would sum under four rows)."""
    vec, rpi, rows, chunks = tg.plan(16, L, C, dtype)
    assert vec == 16 // torch.empty((), dtype=dtype).element_size() and C % vec == 0
    assert 1 <= C // vec * rpi <= 1024 and rpi == max(1, tg.THREADS // (C // vec))
    assert (chunks - 1) * rows < L <= chunks * rows
    assert 16 * chunks <= 4 * tg.SMS + 16 or rows <= 4 * rpi
