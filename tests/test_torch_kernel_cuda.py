"""The SD attention kernels against their plain versions on a CUDA device.

Skips without a card. On one, run it without the JAX test setup:
    python -m pytest --noconftest -m requires_cuda tests/test_torch_kernel_cuda.py -q
"""

import math

import pytest
import torch

from sliders_tpu_torch.ops import sd_attention as sa


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU or interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize(
    "shape,dtype,tol",
    [
        # bf16: the plain version rounds p and o at the same points; sums in
        # another order leave an element one or two ulps (<= 2**-9 at |o| < 0.5)
        ((2, 8, 4096, 40), torch.bfloat16, 2**-8),
        ((2, 8, 1024, 80), torch.bfloat16, 2**-8),
        ((1, 3, 1000, 8), torch.bfloat16, 2**-8),  # ragged last q/k tile
        ((1, 2, 1000, 128), torch.float32, 1e-5),
    ],
)
def test_kernel_matches_plain(cuda, shape, dtype, tol):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype) for _ in range(3))
    launches = sa.sd_attention.launches
    out = sa.sd_attention(q, k, v)
    torch.cuda.synchronize()
    assert sa.sd_attention.launches == launches + 1
    ref = sa.sd_attention_ref(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.requires_cuda
def test_kernel_takes_head_strided_views(cuda):
    """(B, L, H*d) projection output viewed as (B, H, L, d): no copy needed."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((2, 1024, 8 * 40), generator=gen, device=cuda).bfloat16() * 0.3
    qh = x.view(2, 1024, 8, 40).permute(0, 2, 1, 3)
    out = sa.sd_attention(qh, qh, qh)
    ref = sa.sd_attention_ref(qh, qh, qh)
    assert (out.float() - ref.float()).abs().max().item() <= 2**-7


def _ulps_bf16(ref_max: float) -> float:
    """One bf16 ulp at the largest magnitude of the reference."""
    return 2.0 ** (math.floor(math.log2(max(ref_max, 2.0**-30))) - 7)


@pytest.mark.requires_cuda
@pytest.mark.parametrize(
    "shape,dtype",
    [
        ((1, 8, 4096, 40), torch.bfloat16),  # SD1.5 grad pass, level 0
        ((1, 8, 1024, 80), torch.bfloat16),  # SD1.5 grad pass, level 1
        ((1, 3, 1000, 8), torch.bfloat16),  # ragged last q/k tile
        ((1, 2, 1024, 128), torch.bfloat16),
        ((1, 2, 1000, 40), torch.float32),
    ],
)
def test_bwd_kernel_matches_plain(cuda, shape, dtype):
    """dq, dk, dv of the backward kernel against sd_attention_bwd_ref. bf16:
    both round p and ds at the same points and differ in summation order and
    the fast exp, so a rounding may flip; held to 4 bf16 ulps at each
    output's largest magnitude. f32: 1e-5 relative to the largest value."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v, g = (torch.randn(shape, generator=gen, device=cuda).to(dtype) for _ in range(4))
    launches = sa.sd_attention_bwd.launches
    out = sa.sd_attention_bwd(q, k, v, g)
    torch.cuda.synchronize()
    assert sa.sd_attention_bwd.launches == launches + 1
    ref = sa.sd_attention_bwd_ref(q, k, v, g)
    for name, o, r in zip(("dq", "dk", "dv"), out, ref):
        assert o.shape == r.shape and o.dtype == dtype
        ref_max = r.float().abs().max().item()
        tol = 4 * _ulps_bf16(ref_max) if dtype == torch.bfloat16 else 1e-5 * max(1.0, ref_max)
        err = (o.float() - r.float()).abs().max().item()
        assert err <= tol, (name, err, tol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize(
    "length,heads,width,dtype,rel_tol",
    [
        # f32: both routes compute in f32 throughout
        (1024, 2, 80, torch.float32, 1e-5),
        (4096, 2, 80, torch.float32, 1e-5),
        # bf16: the plain route's autograd rounds dp to bf16 and keeps ds in
        # f32, where the kernel keeps dp in f32 and rounds ds (the JAX
        # kernel's cast points): 16 bf16 ulps at the largest magnitude
        (4096, 8, 320, torch.bfloat16, 2.0**-6),
        (1024, 8, 640, torch.bfloat16, 2.0**-6),
    ],
)
def test_routed_attention_grads_match_plain_route(cuda, length, heads, width, dtype, rel_tol):
    """The repaired fault: a routed self-attention under grad carries a
    grad_fn, its dq/dk/dv come from the backward kernel, and they equal the
    plain route's gradients."""
    from sliders_tpu_torch.ops import attention as ta

    gen = torch.Generator(device=cuda).manual_seed(3)
    x = [(torch.randn((1, length, width), generator=gen, device=cuda) * 0.5).to(dtype)
         for _ in range(4)]
    q, k, v = (t.clone().requires_grad_() for t in x[:3])
    go = x[3]
    fwd, bwd = sa.sd_attention.launches, sa.sd_attention_bwd.launches
    out = ta.multihead_attention(q, k, v, heads)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (q, k, v), go)
    torch.cuda.synchronize()
    assert (sa.sd_attention.launches, sa.sd_attention_bwd.launches) == (fwd + 1, bwd + 1)

    ta.set_attention_impl("xla")
    try:
        qp, kp, vp = (t.clone().requires_grad_() for t in x[:3])
        plain = torch.autograd.grad(ta.multihead_attention(qp, kp, vp, heads), (qp, kp, vp), go)
    finally:
        ta.set_attention_impl("auto")
    assert (sa.sd_attention.launches, sa.sd_attention_bwd.launches) == (fwd + 1, bwd + 1)
    for gk, gp in zip(grads, plain):
        scale = gp.float().abs().max().item()
        assert (gk.float() - gp.float()).abs().max().item() <= rel_tol * max(scale, 1e-6)
