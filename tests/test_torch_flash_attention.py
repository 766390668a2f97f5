"""Kernel #4's plain version and the port's attention routing, on the CPU,
against the JAX package.

`flash_attention_ref` is the TPU flash kernel's schedule (128-key blocks,
unnormalised p rounded to v's dtype, the accumulator rescaled per block).
It is held to the JAX package's `xla_attention` (exact softmax, normalised
p rounded): in f32 only summation orders differ (1e-6 of the largest
value); in bf16 the two round p at different points (normalised or not), so
an output may move a few bf16 ulps (held to 4 at the largest magnitude).

`flash_attention_bwd_ref`, the plain version of the backward kernels, is
held to `jax.vjp` of the JAX package's `xla_attention` (f32: 2e-5 of the
largest gradient; bf16: 2 ulps at the largest magnitude, since the two round
p and ds at other points) and to `jax.grad` of the stock TPU kernel itself in
interpret mode (f32, 2e-6).

The routing decision (#4 / #1 / plain) of `ops/attention.py` is held to the
JAX package's pure shape functions (`pallas_attention.supports`,
`flash_attention.supports`) over a grid of shapes in bf16 and f32, and the
JAX package's backward decision (#2 or its XLA VJP) is pinned beside it.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_tpu.ops import flash_attention as jfa
from sliders_tpu.ops import pallas_attention as jpa
from sliders_tpu.ops.attention import xla_attention as jax_xla_attention
from sliders_tpu_torch.ops import attention as ta
from sliders_tpu_torch.ops import flash_attention as tfa


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(max(x, 2.0**-30))) - 7)


@pytest.mark.parametrize("shape", [(1, 2, 1024, 128), (1, 1, 1024, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_ref_matches_jax_xla_attention(shape, dtype):
    q, k, v = _qkv(shape, 0)
    jdt = getattr(jnp, dtype)
    ref = np.asarray(jax_xla_attention(*(jnp.asarray(t).astype(jdt) for t in (q, k, v)))
                     .astype(jnp.float32))
    out = tfa.flash_attention_ref(*(torch.from_numpy(t).to(getattr(torch, dtype))
                                    for t in (q, k, v)))
    assert out.dtype == getattr(torch, dtype) and out.shape == shape
    err = np.abs(out.float().numpy() - ref).max()
    scale = np.abs(ref).max()
    tol = 1e-6 * max(1.0, scale) if dtype == "float32" else 4 * _bf16_ulp(scale)
    assert err <= tol, (err, tol)


def test_flash_ref_rounds_unnormalised_p():
    """In bf16 the plain version keeps the TPU kernel's rounding point: with
    one 128-key block its p is round(exp(s - m)) / l, not round(exp(s - m) /
    l), and it differs from the exact-softmax path by that rounding."""
    q, k, v = (torch.from_numpy(t).bfloat16() for t in _qkv((1, 1, 128, 128), 1))
    out = tfa.flash_attention_ref(q, k, v)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * 128**-0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    want = (torch.matmul(p.bfloat16().float(), v.float()) * (1.0 / p.sum(-1, keepdim=True))).bfloat16()
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_flash_wrapper_on_cpu_runs_the_plain_version_and_refuses_grad():
    """CPU tensors run the plain version and never reach the kernel; under
    grad the output carries a gradient through `FlashAttention` at d = 128,
    and d = 512 (the VAE's, never trained) is refused by name."""
    q, k, v = (torch.from_numpy(t) for t in _qkv((1, 2, 256, 128), 2))
    before = tfa.flash_attention.launches
    torch.testing.assert_close(tfa.flash_attention(q, k, v), tfa.flash_attention_ref(q, k, v),
                               rtol=0, atol=0)
    assert tfa.flash_attention.launches == before  # CPU tensors never reach the kernel
    out = tfa.flash_attention(q.clone().requires_grad_(), k, v)
    assert out.grad_fn is not None
    wide = torch.zeros((1, 1, 128, 512), requires_grad=True)
    with pytest.raises(NotImplementedError, match="queue 2, item 3"):
        tfa.flash_attention(wide, wide, wide)


def _jax_vjp(fn, arrays, cotangent):
    out, vjp = jax.vjp(fn, *arrays)
    return out, vjp(cotangent)


@pytest.mark.parametrize("shape", [(1, 2, 256, 128), (1, 1, 384, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_ref_matches_jax_vjp(shape, dtype):
    """dq, dk, dv of the plain backward (from the plain forward's o, m, l)
    against jax.vjp of xla_attention with a random cotangent. f32: only
    summation orders differ (2e-5 of the largest gradient). bf16: the
    backward rounds p and ds to bf16 before the products where JAX's
    autograd rounds at its own points, so an element moves up to 2 bf16
    ulps at the gradient's largest magnitude (1 seen)."""
    q, k, v = _qkv(shape, 5)
    g = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, want = _jax_vjp(jax_xla_attention, [jnp.asarray(t).astype(jdt) for t in (q, k, v)],
                       jnp.asarray(g).astype(jdt))
    tq, tk, tv, tg = (torch.from_numpy(t).to(tdt) for t in (q, k, v, g))
    o, m, l = tfa.flash_attention_fwd_ref(tq, tk, tv)
    assert m.shape == l.shape == shape[:3] and m.dtype == l.dtype == torch.float32
    got = tfa.flash_attention_bwd_ref(tq, tk, tv, o, tg, m, l)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = np.asarray(b.astype(jnp.float32))
        assert a.dtype == tdt and a.shape == shape
        scale = np.abs(b).max()
        tol = 2e-5 * max(1.0, scale) if dtype == "float32" else 2 * _bf16_ulp(scale)
        err = np.abs(a.float().numpy() - b).max()
        assert err <= tol, (name, err, tol)


def test_flash_bwd_ref_matches_stock_kernel_interpret():
    """The plain forward and backward against the stock TPU flash kernel the
    JAX package calls (its custom_vjp: residual forward, dk/dv and dq
    kernels), run in interpret mode as tests/test_flash_attention.py runs
    the forward, f32: within 2e-6 (summation orders only)."""
    from jax.experimental.pallas import tpu as pltpu

    from sliders_tpu.ops import flash_attention as jax_flash

    shape = (1, 1, 1024, 128)
    q, k, v = _qkv(shape, 7)
    g = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        out, want = _jax_vjp(jax_flash.flash_attention, [jnp.asarray(t) for t in (q, k, v)],
                             jnp.asarray(g))
        want = [np.asarray(t) for t in want]
        out = np.asarray(out)
    tq, tk, tv, tg = (torch.from_numpy(t) for t in (q, k, v, g))
    o, m, l = tfa.flash_attention_fwd_ref(tq, tk, tv)
    np.testing.assert_allclose(o.numpy(), out, rtol=0, atol=2e-6)
    for a, b in zip(tfa.flash_attention_bwd_ref(tq, tk, tv, o, tg, m, l), want):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=2e-6)


def test_flash_bwd_ref_rounds_p_and_ds():
    """In bf16 the plain backward keeps the TPU kernels' cast points: p and
    ds are rounded to do's dtype before the products with do and q/k (so dv
    and dk differ from the unrounded products), and ds carries the scale
    before its rounding."""
    q, k, v = (torch.from_numpy(t).bfloat16() for t in _qkv((1, 1, 128, 128), 9))
    g = torch.from_numpy(np.random.default_rng(10).standard_normal((1, 1, 128, 128))
                         .astype(np.float32)).bfloat16()
    o, m, l = tfa.flash_attention_fwd_ref(q, k, v)
    dq, dk, dv = tfa.flash_attention_bwd_ref(q, k, v, o, g, m, l)
    scale = 128**-0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - m[..., None]) * (1.0 / l[..., None])
    di = (o.float() * g.float()).sum(-1, keepdim=True)
    ds = (torch.matmul(g.float(), v.float().transpose(-1, -2)) - di) * p * scale
    want_dv = torch.matmul(p.bfloat16().float().transpose(-1, -2), g.float())
    want_dk = torch.matmul(ds.bfloat16().float().transpose(-1, -2), q.float())
    want_dq = torch.matmul(ds.bfloat16().float(), k.float())
    torch.testing.assert_close(dv, want_dv.bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(dk, want_dk.bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(dq, want_dq.bfloat16(), rtol=0, atol=0)
    unrounded = torch.matmul(p.transpose(-1, -2), g.float()).bfloat16()
    assert not torch.equal(dv, unrounded)


def test_flash_function_grads_on_cpu_equal_the_plain_backward():
    """`FlashAttention` on CPU tensors: the output carries a grad_fn, and its
    gradients are `flash_attention_bwd_ref`'s on the plain forward's
    residuals, bit for bit."""
    q, k, v = (torch.from_numpy(t) for t in _qkv((1, 2, 256, 128), 11))
    g = torch.from_numpy(np.random.default_rng(12).standard_normal((1, 2, 256, 128))
                         .astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tfa.flash_attention(*leaves)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, leaves, g)
    o, m, l = tfa.flash_attention_fwd_ref(q, k, v)
    for a, b in zip(got, tfa.flash_attention_bwd_ref(q, k, v, o, g, m, l)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _jax_route(q_shape, k_shape, mask, itemsize):
    """The JAX package's decision on a TPU (attention.py:193-202 under 'auto')."""
    if mask is not None:
        return "plain"
    if jpa.supports(q_shape, k_shape, itemsize=itemsize):
        return "sd"
    if jfa.supports(q_shape, k_shape):
        return "flash"
    return "plain"


def test_flash_function_under_checkpoint_equals_without():
    """Inside `torch.utils.checkpoint` (the FLUX blocks' remat), the
    backward recomputes the forward and unpacks its saved tensors once; the
    gradients equal those without the checkpoint, bit for bit."""
    from torch.utils.checkpoint import checkpoint

    q, k, v = (torch.from_numpy(t) for t in _qkv((1, 2, 256, 128), 13))
    g = torch.from_numpy(np.random.default_rng(14).standard_normal((1, 2, 256, 128))
                         .astype(np.float32))

    def grads(remat):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fn = (lambda *a: checkpoint(tfa.flash_attention, *a, use_reentrant=False)) if remat \
            else tfa.flash_attention
        return torch.autograd.grad(fn(*leaves) * 2.0, leaves, g)

    for a, b in zip(grads(True), grads(False)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _jax_bwd_route(q_shape, k_shape, mask, itemsize):
    """The JAX package's backward on a TPU for a call its forward routes:
    kernel #2 where #1 routes, d >= BWD_MIN_D and `supports_bwd` holds
    (pallas_attention.py:119-128), else the XLA VJP; the stock kernel's own
    backward for #4."""
    route = _jax_route(q_shape, k_shape, mask, itemsize)
    if route == "sd":
        if q_shape[3] >= jpa.BWD_MIN_D and jpa.supports_bwd(q_shape, k_shape, itemsize=itemsize):
            return "sd_bwd"
        return "xla_vjp"
    return {"flash": "flash_bwd", "plain": "xla_vjp"}[route]


@pytest.mark.parametrize("L,d,itemsize,want", [
    (1536, 128, 2, "sd_bwd"),   # FLUX training at 512 px
    (4608, 128, 2, "xla_vjp"),  # FLUX training at 1024 px: 14.3 MB > the 13 MiB budget
    (4096, 40, 2, "xla_vjp"),   # SD1.5 level 0: d < BWD_MIN_D
    (1024, 80, 2, "xla_vjp"),   # SD1.5 level 1
    (1024, 64, 2, "xla_vjp"),   # SDXL training at 512 px (640-wide level, 10 heads)
    (4096, 64, 2, "xla_vjp"),   # SDXL at 1024 px
    (16896, 128, 2, "flash_bwd"),  # FLUX training at 2048 px
    (9728, 128, 4, "flash_bwd"),   # the tiny FLUX run at 1536 px in f32
])
def test_backward_routing_difference_is_pinned(L, d, itemsize, want):
    """Where the forward takes #1, the JAX package differentiates through
    kernel #2 only for d >= 96 within #2's TPU VMEM budget, else through the
    XLA VJP; the port's backward takes #2 wherever #1 routes (ROADMAP queue
    3). #4's backward follows #4's forward in both."""
    q_shape = (1, 24, L, d)
    assert _jax_bwd_route(q_shape, q_shape, None, itemsize) == want
    port = _port_route(q_shape, q_shape, None, itemsize)
    if want == "flash_bwd":
        assert port == "flash"
    else:
        assert port == "sd" and ta.routes_to_sd_bwd_kernel(q_shape, q_shape, None)


def _port_route(q_shape, k_shape, mask, itemsize):
    if ta.routes_to_flash_kernel(q_shape, k_shape, mask, itemsize):
        return "flash"
    if ta.routes_to_sd_kernel(q_shape, k_shape, mask):
        return "sd"
    return "plain"


SEQS = (77, 512, 1000, 1024, 1536, 4096, 4608, 6016, 6144, 9728, 10112, 10240, 16384, 16896,
        65536)
HEAD_DIMS = (40, 64, 80, 128, 160, 256, 512)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_routing_equals_jax_decision(itemsize):
    """#4 exactly where the JAX package takes the stock kernel; #1 wherever
    the JAX package takes its kernel #1; the shapes neither TPU kernel takes
    stay on the port's #1 where its own gate holds (it streams K/V, so no
    VMEM plan limits it), else plain."""
    for L in SEQS:
        for d in HEAD_DIMS:
            for lk in (L, 77):
                q_shape, k_shape = (2, 24, L, d), (2, 24, lk, d)
                for mask in (None, "mask"):
                    want = _jax_route(q_shape, k_shape, mask, itemsize)
                    got = _port_route(q_shape, k_shape, mask, itemsize)
                    if want == "plain":
                        assert got in ("plain", "sd"), (q_shape, k_shape, mask, itemsize)
                        assert got == ("sd" if ta.routes_to_sd_kernel(q_shape, k_shape, mask)
                                       else "plain")
                    else:
                        assert got == want, (q_shape, k_shape, mask, itemsize, got, want)
                    assert (ta.pa_supports(q_shape, k_shape, itemsize=itemsize)
                            == jpa.supports(q_shape, k_shape, itemsize=itemsize))
                    assert ta.fa_supports(q_shape, k_shape) == jfa.supports(q_shape, k_shape)


@pytest.mark.parametrize("L,itemsize,route", [
    (1536, 2, "sd"), (4608, 2, "sd"), (9728, 2, "sd"), (10112, 2, "sd"), (10240, 2, "flash"),
    (16896, 2, "flash"), (4608, 4, "sd"), (6016, 4, "sd"), (6144, 4, "flash"),
    (9728, 4, "flash"),
])
def test_flux_joint_attention_routes(L, itemsize, route):
    """FLUX's joint attention (d = 128, L = 512 + (S/16)^2): #1's TPU plan
    holds L <= 10,112 in bf16 and about 6,040 in f32; beyond, kernel #4."""
    assert _port_route((1, 24, L, 128), (1, 24, L, 128), None, itemsize) == route
    assert _jax_route((1, 24, L, 128), (1, 24, L, 128), None, itemsize) == route


def test_vae_mid_attention_routes_to_flash():
    """The VAE's single-head mid attention (d = 512 channels) at 64x64
    latents and more: #1 refuses d > 128, the stock kernel takes it."""
    for L in (4096, 16384, 65536):
        assert _port_route((8, 1, L, 512), (8, 1, L, 512), None, 4) == "flash"
        assert _jax_route((8, 1, L, 512), (8, 1, L, 512), None, 4) == "flash"


@pytest.fixture
def spy(monkeypatch):
    calls = {"flash": 0, "sd": 0}

    def wrap(name, fn):
        def inner(*a):
            calls[name] += 1
            return fn(*a)
        return inner

    monkeypatch.setattr(ta, "flash_attention", wrap("flash", ta.flash_attention))
    monkeypatch.setattr(ta, "sd_attention", wrap("sd", ta.sd_attention))
    yield calls
    ta.set_attention_impl("auto")


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_multihead_attention_takes_flash_route(spy, impl):
    """An f32 self-attention at L = 6144, d = 128 goes to #4 (its plain
    version on the CPU) under 'auto' and 'pallas', not under 'xla'."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 6144, 128)).astype(np.float32))
               for _ in range(3))
    ta.set_attention_impl(impl)
    out = ta.multihead_attention(q, k, v, 1)
    assert spy == {"flash": 1, "sd": 0}
    ta.set_attention_impl("xla")
    ref = ta.multihead_attention(q, k, v, 1)
    assert spy == {"flash": 1, "sd": 0}
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


def test_pallas_with_a_mask_stays_plain(spy):
    """Under 'pallas' the JAX package sends a masked call that #1 refuses to
    the stock kernel, dropping the mask (attention.py:199); the port keeps
    the gates of 'auto', so T5's position bias is never lost."""
    rng = np.random.default_rng(4)
    L = 2048
    q, k, v = (torch.from_numpy(rng.standard_normal((1, L, 256)).astype(np.float32))
               for _ in range(3))
    mask = torch.from_numpy(rng.standard_normal((1, 2, L, L)).astype(np.float32))
    ta.set_attention_impl("pallas")
    out = ta.multihead_attention(q, k, v, 2, mask=mask)
    assert spy == {"flash": 0, "sd": 0}
    qh, kh, vh = (t.view(1, L, 2, 128).permute(0, 2, 1, 3) for t in (q, k, v))
    want = ta.xla_attention(qh, kh, vh, mask).permute(0, 2, 1, 3).reshape(1, L, 256)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
