"""The hand-written kernels (SD attention #1-#2, flash attention #4 and its
backward, conv #5-#7, GroupNorm #8, the layout pin #9) against their plain
versions on a CUDA device, a tiny FLUX training step through them, and the
tiny SDXL UNet's gradient with the layout pin on.

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
        ((2, 20, 1024, 64), torch.bfloat16, 2**-8),  # SDXL's L = 1024 level, 2 of 16 rows
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


def _bwd_within_tolerance(out, ref, dtype):
    """dq, dk, dv against the plain version: bf16 within 4 ulps at each
    output's largest magnitude, f32 within 1e-5 of it."""
    for name, o, r in zip(("dq", "dk", "dv"), out, ref):
        assert o.shape == r.shape and o.dtype == dtype, name
        ref_max = r.float().abs().max().item()
        tol = 4 * _ulps_bf16(ref_max) if dtype == torch.bfloat16 else 1e-5 * max(1.0, ref_max)
        err = (o.float() - r.float()).abs().max().item()
        assert err <= tol, (name, err, tol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize(
    "shape,dtype",
    [
        ((1, 8, 4096, 40), torch.bfloat16),  # SD1.5 grad pass, level 0
        ((1, 8, 1024, 80), torch.bfloat16),  # SD1.5 grad pass, level 1
        ((1, 10, 1024, 64), torch.bfloat16),  # SDXL grad pass at 512 px
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
    _bwd_within_tolerance(out, sa.sd_attention_bwd_ref(q, k, v, g), dtype)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("length", [1000, 1090, 100])
@pytest.mark.parametrize("d", list(range(8, 129, 8)))
def test_bwd_kernel_every_head_dim_and_ragged_length(cuda, d, length, dtype):
    """#2's backward on the Hopper backward mainloop at every head dim the
    gate takes (TMA where a row is 128, 256 or 512 bytes, cp.async with
    zero-filled pad columns elsewhere), bf16 on the PAIR plan and f32 on the
    TF32 plan (three TF32 products a step), at B = 2 and lengths that leave
    a ragged last q and key tile (1000, 1090) and one below a tile (100):
    bf16 within 4 ulps of sd_attention_bwd_ref at each output's largest
    magnitude, f32 within 1e-5 of it, one counted launch."""
    gen = torch.Generator(device=cuda).manual_seed(d * 11 + length)
    q, k, v, g = (torch.randn((2, 3, length, d), generator=gen, device=cuda).to(dtype)
                  for _ in range(4))
    launches = sa.sd_attention_bwd.launches
    out = sa.sd_attention_bwd(q, k, v, g)
    torch.cuda.synchronize()
    assert sa.sd_attention_bwd.launches == launches + 1
    _bwd_within_tolerance(out, sa.sd_attention_bwd_ref(q, k, v, g), dtype)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [40, 64, 80, 128])
def test_bwd_kernel_takes_head_views(cuda, d, dtype):
    """#2's backward on (B, H, L, d) head views of (B, L, H*d) buffers (q, k,
    v and g), B = 2, a ragged L: the kernels (and, in f32, the split pass)
    read the strides as they lie."""
    gen = torch.Generator(device=cuda).manual_seed(d + 3)
    q, k, v, g = (_heads(torch.randn((2, 1090, 3 * d), generator=gen, device=cuda).to(dtype), 3)
                  for _ in range(4))
    out = sa.sd_attention_bwd(q, k, v, g)
    _bwd_within_tolerance(out, sa.sd_attention_bwd_ref(q, k, v, g), dtype)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kernel,shape,dtype", [
    ("sd", (1, 8, 1024, 80), torch.bfloat16), ("sd", (2, 3, 1090, 128), torch.bfloat16),
    ("sd", (1, 8, 4096, 40), torch.bfloat16), ("flash", (1, 3, 2048, 128), torch.bfloat16),
    ("flash", (2, 2, 1024, 256), torch.bfloat16), ("sd", (1, 8, 4096, 40), torch.float32),
    ("sd", (2, 3, 1090, 128), torch.float32), ("sd", (1, 10, 1024, 64), torch.float32),
    ("flash", (1, 2, 1024, 128), torch.float32), ("flash", (1, 2, 6912, 128), torch.float32),
    ("flash", (1, 3, 2048, 256), torch.float32), ("flash", (1, 1, 1024, 512), torch.float32),
    ("sd_fwd", (1, 8, 4096, 40), torch.float32), ("sd_fwd", (2, 3, 1090, 128), torch.float32),
    ("sd_fwd", (1, 10, 1024, 64), torch.float32)])
def test_bwd_kernels_are_deterministic(cuda, kernel, shape, dtype):
    """Two launches of a backward on the same inputs give bit-identical dq,
    dk and dv: no atomics, every sum in a fixed order (#4's f32 d = 256 and
    512: the cluster's partials added in rank order). So do two launches of
    #1's f32 forward ('sd_fwd': its split pass and two-pass kernel)."""
    from sliders_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(35)
    B, H, L, d = shape
    q, k, v, g = (_heads(torch.randn((B, L, H * d), generator=gen, device=cuda).to(dtype), H)
                  for _ in range(4))
    if kernel == "sd":
        first, second = sa.sd_attention_bwd(q, k, v, g), sa.sd_attention_bwd(q, k, v, g)
    elif kernel == "sd_fwd":
        first, second = (sa.sd_attention(q, k, v),), (sa.sd_attention(q, k, v),)
    else:
        o, m, l = fa._forward(q, k, v, residuals=True)
        first = fa.flash_attention_bwd(q, k, v, o, g, m, l)
        second = fa.flash_attention_bwd(q, k, v, o, g, m, l)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kernel,shape", [("sd", (1, 3, 1024, 64)), ("sd", (1, 2, 1000, 40)),
                                          ("flash", (1, 2, 2048, 128))])
def test_attention_function_under_checkpoint_equals_without(cuda, kernel, shape):
    """SdAttention and FlashAttention under non-reentrant checkpoint (the
    training path's remat) give the same gradients as without it, bit for
    bit: the recomputed forward and the backward kernels are deterministic,
    and the Function reads its saved tensors once."""
    from torch.utils.checkpoint import checkpoint

    from sliders_tpu_torch.ops import flash_attention as fa

    fn = sa.sd_attention if kernel == "sd" else fa.flash_attention
    gen = torch.Generator(device=cuda).manual_seed(36)
    x = [torch.randn(shape, generator=gen, device=cuda).bfloat16() for _ in range(4)]

    def grads(remat):
        q, k, v = (t.clone().requires_grad_() for t in x[:3])
        out = checkpoint(fn, q, k, v, use_reentrant=False) if remat else fn(q, k, v)
        return torch.autograd.grad(out, (q, k, v), x[3])

    for name, a, b in zip(("dq", "dk", "dv"), grads(True), grads(False)):
        assert torch.equal(a, b), name


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
        # f32 at SD1.5's two levels: #1's and #2's 3xTF32 kernels
        (4096, 8, 320, torch.float32, 1e-5),
        (1024, 8, 640, torch.float32, 1e-5),
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


@pytest.mark.requires_cuda
@pytest.mark.parametrize("length", [1000, 1090, 100])
@pytest.mark.parametrize("d", list(range(8, 129, 8)))
def test_kernel_every_head_dim_and_ragged_length(cuda, d, length):
    """#1's bf16 forward on the Hopper mainloop at every head dim the gate
    takes (TMA at d = 64 and 128, cp.async with zero-filled pad columns
    elsewhere), at lengths that leave a ragged last q and key tile (1000,
    1090) and one below the 128-row q tile (100): within 4 bf16 ulps of the
    plain version at the output's largest magnitude, one launch each."""
    gen = torch.Generator(device=cuda).manual_seed(d * 7 + length)
    q, k, v = (torch.randn((2, 3, length, d), generator=gen, device=cuda).bfloat16()
               for _ in range(3))
    launches = sa.sd_attention.launches
    out = sa.sd_attention(q, k, v)
    torch.cuda.synchronize()
    assert sa.sd_attention.launches == launches + 1
    ref = sa.sd_attention_ref(q, k, v)
    tol = 4 * _ulps_bf16(ref.float().abs().max().item())
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", [(4, 40, 1090, 40), (4, 40, 1000, 64), (2, 40, 1000, 128)])
def test_kernel_walks_several_items_per_block(cuda, shape):
    """More 128-row q tiles than the card has SMs: each block of #1's
    persistent grid walks several (q tile, head, batch) items, the ring's
    stages and phases running on from one to the next (cp.async at d = 40,
    TMA at 64 and 128); every item within 4 bf16 ulps of the plain
    version."""
    gen = torch.Generator(device=cuda).manual_seed(34)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).bfloat16() for _ in range(3))
    out = sa.sd_attention(q, k, v)
    ref = sa.sd_attention_ref(q, k, v)
    tol = 4 * _ulps_bf16(ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= tol


def _f32_fwd_within(out, ref):
    """#1's f32 forward against its plain version: within 1e-5 of max(1, the
    output's largest magnitude), in f32 and of the reference's shape."""
    assert out.shape == ref.shape and out.dtype == torch.float32
    tol = 1e-5 * max(1.0, ref.abs().max().item())
    err = (out - ref).abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("lengths", [(1000, 1000), (1090, 1090), (100, 100), (1000, 1090),
                                     (130, 70)])
@pytest.mark.parametrize("d", list(range(8, 129, 8)))
def test_f32_kernel_every_head_dim_and_ragged_length(cuda, d, lengths):
    """#1's f32 forward on 3xTF32 `wgmma` (after its split pass) at every
    head dim the gate takes, B = 2, 3 heads, lengths that leave a ragged
    last q and key tile, one below a tile, and Lq != Lk both ways: within
    1e-5 of the plain version (f32, TF32 off), one counted launch."""
    Lq, Lk = lengths
    gen = torch.Generator(device=cuda).manual_seed(d * 13 + Lq + 3 * Lk)
    q = torch.randn((2, 3, Lq, d), generator=gen, device=cuda)
    k, v = (torch.randn((2, 3, Lk, d), generator=gen, device=cuda) for _ in range(2))
    launches = sa.sd_attention.launches
    out = sa.sd_attention(q, k, v)
    torch.cuda.synchronize()
    assert sa.sd_attention.launches == launches + 1
    _f32_fwd_within(out, sa.sd_attention_ref(q, k, v))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("d", [40, 64, 80, 128])
def test_f32_kernel_takes_head_views(cuda, d):
    """#1's f32 forward on (B, H, L, d) head views of (B, L, H*d) buffers
    (q, k and v, as the UNet and FLUX pass them), B = 2, a ragged L and
    more items than SMs: the split pass and the kernel read the strides as
    they lie; the output is a (B, H, L, d) view of a (B, L, H, d) buffer."""
    gen = torch.Generator(device=cuda).manual_seed(d + 37)
    q, k, v = (_heads(torch.randn((2, 1090, 40 * d), generator=gen, device=cuda), 40)
               for _ in range(3))
    out = sa.sd_attention(q, k, v)
    assert out.permute(0, 2, 1, 3).is_contiguous()
    _f32_fwd_within(out, sa.sd_attention_ref(q, k, v))


@pytest.mark.requires_cuda
def test_f32_kernel_refuses_what_it_does_not_take(cuda):
    """#1's f32 entry takes d in [8, 128] in steps of 8 and raises on the
    rest, as the bf16 one does; no CPU fallback for a CUDA tensor."""
    for d in (4, 12, 136):
        q = torch.randn((1, 1, 128, d), device=cuda)
        with pytest.raises(ValueError):
            sa.sd_attention(q, q, q)


# ---------------------------------------------------------------------------
# conv kernels #5-#7 and the GroupNorm kernel #8
# ---------------------------------------------------------------------------

CONV_CASES = [
    # (B, H, W, C, N), dtype
    ((2, 32, 32, 320, 640), torch.bfloat16),  # an SD1.5 shape
    ((1, 16, 24, 100, 200), torch.bfloat16),  # C not a multiple of 8: element loads; N ragged
    ((3, 17, 15, 64, 131), torch.bfloat16),   # M ragged, N odd: element stores
    ((2, 16, 16, 96, 129), torch.float32),
    ((1, 32, 32, 320, 320), torch.float32),
    # f32 on the 3xTF32 mainloop: ragged M and N with a partial chunk, an odd
    # N at W = 9, a 1 x 128 tile; C % 4 != 0 stays on the generic kernel
    ((1, 13, 40, 100, 136), torch.float32),
    ((2, 9, 9, 72, 129), torch.float32),
    ((2, 1, 128, 64, 256), torch.float32),
    ((1, 16, 24, 102, 200), torch.float32),
    # the Hopper mainloop's edges: a 1 x 128 tile (W = 128), 8 x 16 tiles
    # with H not a multiple of 8 and N = 320 (BN 160), a ragged W and N with
    # a partial channel chunk, an odd N at W = 9 (8-column tiles), and #6's
    # halo outside the image on every side
    ((2, 1, 128, 64, 256), torch.bfloat16),
    ((2, 20, 16, 128, 320), torch.bfloat16),
    ((1, 13, 40, 96, 136), torch.bfloat16),
    ((2, 9, 9, 72, 129), torch.bfloat16),
]


def _variant(shape, dtype) -> str:
    """The kernel `ops/conv3x3.plan` gives a contiguous input: the Hopper
    mainloop where C is a multiple of 16 bytes (8 bf16 or 4 f32 channels)
    and W >= 8, else the generic one."""
    vec = 8 if dtype == torch.bfloat16 else 4
    return "hopper" if shape[3] % vec == 0 and shape[2] >= 8 else "generic"
CONV_KERNELS = [("conv3x3", "none"), ("epi", "none"), ("epi", "temb"), ("epi", "residual"),
                ("fused", "none"), ("fused", "temb"), ("fused", "residual")]


def _conv_inputs(shape, dtype, mode, device, seed=5):
    B, H, W, C, N = shape
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*s, scale=1.0):
        return torch.randn(s, generator=gen, device=device) * scale

    x = (randn(B, H, W, C) * 2 + 0.5).to(dtype)
    w = randn(N, C, 3, 3, scale=(9 * C) ** -0.5).to(dtype).contiguous(
        memory_format=torch.channels_last)  # the port's one conv-weight layout
    b = randn(N, scale=0.1).to(dtype)
    a = 1.0 + randn(B, C, scale=0.1)
    s = randn(B, C, scale=0.3)
    extra = {"none": None, "temb": randn(B, N).to(dtype),
             "residual": randn(B, H, W, N).to(dtype)}[mode]
    return x, a, s, w, b, extra


def _conv_call(kernel, mode, x, a, s, w, b, extra, ref=False):
    from sliders_tpu_torch.ops import conv3x3 as tc

    if kernel == "conv3x3":
        return (tc.conv3x3_ref if ref else tc.conv3x3)(x, w, b)
    if kernel == "epi":
        return (tc.epi_conv3x3_ref if ref else tc.epi_conv3x3)(x, w, b, extra, mode)
    return (tc.fused_conv3x3_ref if ref else tc.fused_conv3x3)(x, a, s, w, b, extra, mode)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape,dtype", CONV_CASES)
@pytest.mark.parametrize("kernel,mode", CONV_KERNELS)
def test_conv_kernels_match_plain(cuda, shape, dtype, kernel, mode):
    """Kernels #5-#7 against their plain versions (f32 accumulation, one
    rounding). bf16: both round once from f32 sums taken in other orders,
    held to 2 bf16 ulps at the largest magnitude; f32: 1e-5 relative, TF32
    off on the plain side."""
    from sliders_tpu_torch.ops import conv3x3 as tc

    torch.backends.cudnn.allow_tf32 = False
    args = _conv_inputs(shape, dtype, mode, cuda)
    fn = {"conv3x3": tc.conv3x3, "epi": tc.epi_conv3x3, "fused": tc.fused_conv3x3}[kernel]
    launches, variants = fn.launches, dict(fn.variants)
    out = _conv_call(kernel, mode, *args)
    torch.cuda.synchronize()
    assert fn.launches == launches + 1
    variants[_variant(shape, dtype)] += 1
    assert fn.variants == variants
    ref = _conv_call(kernel, mode, *args, ref=True)
    assert out.dtype == dtype and out.shape == ref.shape and out.is_contiguous()
    ref_max = ref.float().abs().max().item()
    tol = 2 * _ulps_bf16(ref_max) if dtype == torch.bfloat16 else 1e-5 * max(1.0, ref_max)
    assert (out.float() - ref.float()).abs().max().item() <= tol


# (H, C, N) of the SD VAE decoder's f32 convs under 'auto' (chip_smoke.py's
# VAE_CONV_SHAPES), and the tiny 'fused' training UNet's (128 channels at
# 32 x 32 and 16 x 16) at the training batches 1-3
VAE_F32 = [(64, 512, 512), (128, 512, 512), (256, 512, 512), (256, 512, 256),
           (256, 256, 256), (512, 256, 256), (512, 256, 128), (512, 128, 128)]
TRAIN_F32 = [(b, h, h, 128, 128) for b in (1, 2, 3) for h in (32, 16)]


def _f32_within(out, ref) -> bool:
    """The f32 kernels' tolerance: 1e-5 of the largest value (TF32 off on
    the plain side)."""
    return (out - ref).abs().max().item() <= 1e-5 * max(1.0, ref.abs().max().item())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("h,c,n", VAE_F32)
def test_f32_conv_kernels_at_vae_shapes(cuda, h, c, n):
    """#5, #7 (residual) and #6 (residual) in f32 at the VAE decoder's shapes
    (one image): the 3xTF32 mainloop, one weight split a call, within 1e-5
    of the largest value of the exact-f32 plain version."""
    from sliders_tpu_torch.ops import conv3x3 as tc

    torch.backends.cudnn.allow_tf32 = False
    x, a, s, w, b, extra = _conv_inputs((1, h, h, c, n), torch.float32, "residual", cuda)
    for kernel, mode in (("conv3x3", "none"), ("epi", "residual"), ("fused", "residual")):
        fn = {"conv3x3": tc.conv3x3, "epi": tc.epi_conv3x3, "fused": tc.fused_conv3x3}[kernel]
        hopper, splits = fn.variants["hopper"], tc.tf32_split.launches
        e = extra if mode == "residual" else None
        out = _conv_call(kernel, mode, x, a, s, w, b, e)
        torch.cuda.synchronize()
        assert fn.variants["hopper"] == hopper + 1 and tc.tf32_split.launches == splits + 1
        assert _f32_within(out, _conv_call(kernel, mode, x, a, s, w, b, e, ref=True)), kernel


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", TRAIN_F32)
def test_f32_fused_conv_at_training_batches(cuda, shape):
    """#6 in f32 at the tiny 'fused' training UNet's shapes, with temb and
    with a residual, on the 3xTF32 mainloop."""
    from sliders_tpu_torch.ops import conv3x3 as tc

    torch.backends.cudnn.allow_tf32 = False
    for mode in ("temb", "residual"):
        args = _conv_inputs(shape, torch.float32, mode, cuda)
        hopper = tc.fused_conv3x3.variants["hopper"]
        out = _conv_call("fused", mode, *args)
        assert tc.fused_conv3x3.variants["hopper"] == hopper + 1
        assert _f32_within(out, _conv_call("fused", mode, *args, ref=True)), mode


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", [(512, 512), (128, 256), (136, 100), (7, 13)])
def test_tf32_split_kernel_equals_plain(cuda, shape):
    """The `tf32_split` kernel gives `tf32_split_ref`'s bits, ties (13
    dropped bits of 0x1000) and values past them included, one launch a
    call; by 16-byte accesses, and by 4-byte ones where 9 N C % 4 != 0."""
    from sliders_tpu_torch.ops import conv3x3 as tc

    n, c = shape
    gen = torch.Generator(device=cuda).manual_seed(8)
    w = torch.randn((n, c, 3, 3), generator=gen, device=cuda) * (9 * c) ** -0.5
    bits = w.view(torch.int32)
    bits[: n // 4] = (bits[: n // 4] & -0x2000) | 0x1000  # exact ties, both signs
    bits[n // 4: n // 2] = (bits[n // 4: n // 2] & -0x2000) | 0x1001
    w = w.contiguous(memory_format=torch.channels_last)
    before = tc.tf32_split.launches
    got = tc.tf32_split(w)
    torch.cuda.synchronize()
    assert tc.tf32_split.launches == before + 1
    assert got.shape == (2, n, 3, 3, c) and torch.equal(got, tc.tf32_split_ref(w.cpu()).to(cuda))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kernel,mode", [("conv3x3", "none"), ("epi", "residual"),
                                         ("fused", "temb")])
@pytest.mark.parametrize("shape", [(8, 64, 64, 512, 512), (2, 13, 40, 96, 136)])
def test_f32_conv_kernels_are_deterministic(cuda, kernel, mode, shape):
    """The 3xTF32 mainloop has no split-K and no atomics either: two launches
    give the same bits."""
    args = _conv_inputs(shape, torch.float32, mode, cuda)
    assert torch.equal(_conv_call(kernel, mode, *args), _conv_call(kernel, mode, *args))


@pytest.mark.requires_cuda
def test_conv_kernel_takes_strided_views(cuda):
    """x and the residual as channel slices of wider tensors: contiguous
    channels with other strides are taken as they lie."""
    from sliders_tpu_torch.ops import conv3x3 as tc

    x, a, s, w, b, _ = _conv_inputs((2, 16, 16, 128, 128), torch.bfloat16, "none", cuda)
    wide = torch.cat([x, x.flip(-1)], dim=-1)[..., 128:]
    res = torch.cat([x, x], dim=-1)[..., :128]
    assert wide.stride(2) == 256 and not wide.is_contiguous()
    # strides and an offset of 16-byte multiples: TMA reads the view as it
    # lies; an offset of 4 channels (8 bytes) leaves it to the generic kernel
    shifted = torch.cat([x[..., :4], x], dim=-1)[..., 4:]
    for view, variant in ((wide, "hopper"), (shifted, "generic")):
        taken = tc.fused_conv3x3.variants[variant]
        out = tc.fused_conv3x3(view, a, s, w, b, res, "residual")
        assert tc.fused_conv3x3.variants[variant] == taken + 1
        ref = tc.fused_conv3x3_ref(view, a, s, w, b, res, "residual")
        assert (out.float() - ref.float()).abs().max().item() <= 2 * _ulps_bf16(
            ref.float().abs().max().item())


_RCP_CHECK = r'''
#include "conv3x3_sm90.cuh"
__global__ void differ(unsigned long long* bad, uint32_t lo, uint32_t hi) {
  for (uint32_t i = lo + blockIdx.x * blockDim.x + threadIdx.x; i < hi;
       i += gridDim.x * blockDim.x) {
    const float d = __uint_as_float(i);
    if (__float_as_uint(conv_sm90::rcp_rn(d)) != __float_as_uint(__frcp_rn(d)))
      atomicAdd(bad, 1ull);
  }
}
extern "C" int rcp_rn_differs(unsigned long long* out, unsigned lo, unsigned hi) {
  unsigned long long* bad;
  if (cudaMalloc(&bad, 8) != cudaSuccess) return -1;
  cudaMemset(bad, 0, 8);
  differ<<<132 * 16, 256>>>(bad, lo, hi);
  cudaMemcpy(out, bad, 8, cudaMemcpyDeviceToHost);
  cudaFree(bad);
  return (int)cudaGetLastError();
}
'''


@pytest.mark.requires_cuda
def test_transform_reciprocal_is_frcp_rn(cuda, tmp_path):
    """#6's prologue on the Hopper mainloop takes its reciprocal from
    `conv_sm90::rcp_rn`, branch-free, wherever 1 + exp(-u) < 2^126: it
    gives __frcp_rn's bits on every float of [1, 2^126)."""
    import ctypes
    import subprocess

    from sliders_tpu_torch.ops import _build

    src, lib = tmp_path / "rcp_check.cu", tmp_path / "librcp_check.so"
    src.write_text(_RCP_CHECK)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).rcp_rn_differs
    fn.argtypes = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_uint]
    bad = ctypes.c_ulonglong(1)
    assert fn(ctypes.byref(bad), 0x3F800000, 0x7E800000) == 0  # 1.0 .. 2^126
    assert bad.value == 0


@pytest.mark.requires_cuda
def test_fused_prologue_takes_its_exact_path_below_minus_87(cuda):
    """Where x a + s < -87 somewhere in a warp's batch, the Hopper #6
    rewrites that batch through prologue16 itself; the output stays the
    plain version's."""
    from sliders_tpu_torch.ops import conv3x3 as tc

    x, a, s, w, b, extra = _conv_inputs((2, 16, 16, 128, 128), torch.bfloat16, "temb", cuda)
    x[:, 3:5, 2:9, :16] = -120.0
    x[0, 12, 1, 64:72] = 200.0
    taken = tc.fused_conv3x3.variants["hopper"]
    out = tc.fused_conv3x3(x, a, s, w, b, extra, "temb")
    assert tc.fused_conv3x3.variants["hopper"] == taken + 1
    ref = tc.fused_conv3x3_ref(x, a, s, w, b, extra, "temb")
    assert (out.float() - ref.float()).abs().max().item() <= 2 * _ulps_bf16(
        ref.float().abs().max().item())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kernel,mode", [("conv3x3", "none"), ("epi", "temb"),
                                         ("fused", "residual")])
@pytest.mark.parametrize("shape", [(16, 16, 16, 1280, 1280), (2, 32, 32, 320, 640),
                                   (2, 16, 16, 100, 200)])
def test_conv_kernels_are_deterministic(cuda, kernel, mode, shape):
    """No split-K and no atomics: two launches on the same inputs give the
    same bits, on the Hopper mainloop (a persistent grid walking several
    tiles a block, the first shape) and on the generic kernel."""
    args = _conv_inputs(shape, torch.bfloat16, mode, cuda)
    first = _conv_call(kernel, mode, *args)
    assert torch.equal(first, _conv_call(kernel, mode, *args))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape,dtype", [((2, 16, 16, 128, 256), torch.bfloat16),
                                         ((1, 16, 24, 100, 200), torch.bfloat16),
                                         ((2, 16, 16, 96, 129), torch.float32)])
def test_conv_kernels_take_channels_last_weights(cuda, shape, dtype):
    """The weights the port draws (`ParamFactory.conv`) and moves to the card
    (`tree_to`) are channels_last, the one layout the kernels read: both
    give the same output, and the contiguous OIHW copy of the weight raises
    rather than being read or copied."""
    from sliders_tpu_torch.models.params import ParamFactory, tree_to

    x, a, s, w, b, extra = _conv_inputs(shape, dtype, "temb", cuda)
    drawn = ParamFactory(None, dtype, cuda).conv(shape[3], shape[4])["weight"]
    moved = tree_to({"w": w.contiguous()}, cuda)["w"]
    for t in (drawn, moved):
        assert not t.is_contiguous() and t.is_contiguous(memory_format=torch.channels_last)
    for kernel in ("conv3x3", "fused"):
        out = _conv_call(kernel, "temb", x, a, s, moved, b, extra)
        assert torch.equal(out, _conv_call(kernel, "temb", x, a, s, w, b, extra))
        with pytest.raises(ValueError, match="channels_last"):
            _conv_call(kernel, "temb", x, a, s, w.contiguous(), b, extra)


@pytest.mark.requires_cuda
def test_conv_kernels_refuse_wrong_layouts(cuda):
    """Channels that are not contiguous (an NCHW tensor viewed as NHWC) or a
    weight that is not channels_last raise: the wrapper never copies to hide
    them."""
    from sliders_tpu_torch.ops import conv3x3 as tc

    x, a, s, w, b, _ = _conv_inputs((1, 16, 16, 64, 128), torch.bfloat16, "none", cuda)
    launches = (tc.conv3x3.launches, tc.epi_conv3x3.launches, tc.fused_conv3x3.launches)
    nchw_view = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="contiguous channels"):
        tc.conv3x3(nchw_view, w, b)
    with pytest.raises(ValueError, match="contiguous channels"):
        tc.epi_conv3x3(x, w, b, torch.zeros((1, 128, 16, 16), device=cuda,
                                            dtype=x.dtype).permute(0, 2, 3, 1), "residual")
    with pytest.raises(ValueError, match="OIHW weight"):
        tc.fused_conv3x3(x, a, s, w.transpose(2, 3), b)
    with pytest.raises(ValueError, match="OIHW weight"):
        tc.epi_conv3x3(x, w.contiguous(), b)
    with pytest.raises(ValueError, match="one dtype"):
        tc.conv3x3(x, w.float(), b)
    assert launches == (tc.conv3x3.launches, tc.epi_conv3x3.launches, tc.fused_conv3x3.launches)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kernel,mode", CONV_KERNELS)
def test_conv_function_grads_match_autograd_through_plain(cuda, kernel, mode):
    """The autograd Functions' gradients for every input (a and s of #6
    included) against autograd through the plain version, in f32 with TF32
    off: the backward is the same formula, so only sums in other orders
    differ (1e-4 relative)."""
    torch.backends.cudnn.allow_tf32 = False
    args = _conv_inputs((2, 16, 16, 64, 128), torch.float32, mode, cuda)
    g = torch.randn((2, 16, 16, 128), generator=torch.Generator(device=cuda).manual_seed(6),
                    device=cuda)
    used = [0, 3, 4] + ([5] if mode != "none" else []) + ([1, 2] if kernel == "fused" else [])
    grads = []
    for ref in (False, True):
        leaves = [None if t is None else t.clone().requires_grad_(i in used)
                  for i, t in enumerate(args)]
        out = _conv_call(kernel, mode, *leaves, ref=ref)
        grads.append(torch.autograd.grad(out, [leaves[i] for i in used], g))
    for i, gk, gp in zip(used, *grads):
        scale = gp.abs().max().item()
        assert (gk - gp).abs().max().item() <= 1e-4 * max(scale, 1e-6), i


@pytest.mark.requires_cuda
def test_fused_resnet_grad_reaches_x_through_group_norm(cuda):
    """A 'fused' resnet block's input gradient, which flows partly through
    the GN statistics into kernel #6's a and s, equals the plain block's
    ('xla'), in f32 with TF32 off."""
    from sliders_tpu_torch.models import unet2d
    from sliders_tpu_torch.models.params import tree_to
    from sliders_tpu_torch.ops import basic
    from sliders_tpu_torch.ops import conv3x3 as tc

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(7)

    def randn(*shape, scale):
        return torch.randn(shape, generator=gen, device=cuda) * scale

    def norm(c):
        return {"weight": 1.0 + randn(c, scale=0.1), "bias": randn(c, scale=0.1)}

    def conv(o, i, k):
        return {"weight": randn(o, i, k, k, scale=(i * k * k) ** -0.5), "bias": randn(o, scale=0.1)}

    p = {"norm1": norm(64), "conv1": conv(128, 64, 3), "norm2": norm(128),
         "conv2": conv(128, 128, 3), "conv_shortcut": conv(128, 64, 1),
         "time_emb_proj": {"weight": randn(128, 16, scale=0.25), "bias": randn(128, scale=0.1)}}
    p = tree_to(p, cuda)  # conv weights channels_last, as the port lays them out
    x0 = randn(2, 16, 16, 64, scale=2.0) + 0.5
    emb = randn(2, 16, scale=1.0)
    cfg = unet2d.TINY  # 8 groups
    grads = {}
    for impl in ("fused", "xla"):
        basic.set_conv_impl(impl)
        try:
            x = x0.clone().requires_grad_()
            launches = tc.fused_conv3x3.launches
            out = unet2d._resnet(p, x, emb, cfg, None, "blk")
            (out ** 2).sum().backward()
            assert tc.fused_conv3x3.launches - launches == (2 if impl == "fused" else 0)
            grads[impl] = x.grad
        finally:
            basic.set_conv_impl("xla")
    scale = grads["xla"].abs().max().item()
    assert (grads["fused"] - grads["xla"]).abs().max().item() <= 1e-4 * scale


@pytest.mark.requires_cuda
@pytest.mark.parametrize(
    "shape,groups,silu,dtype",
    [
        ((16, 4096, 320), 32, True, torch.bfloat16),   # SD1.5 norm1 at level 0
        ((16, 4096, 640), 32, True, torch.bfloat16),
        ((16, 4096, 960), 32, True, torch.bfloat16),
        ((16, 4096, 320), 32, False, torch.bfloat16),  # a transformer norm
        ((16, 1024, 1280), 32, False, torch.bfloat16),
        ((16, 1024, 640), 32, True, torch.bfloat16),
        ((16, 1024, 1920), 32, True, torch.bfloat16),
        ((16, 64, 2560), 32, True, torch.bfloat16),     # the 8x8 bottleneck
        ((16, 4096, 320), 32, True, torch.float32),
        ((1, 1000, 96), 8, True, torch.float32),
        ((1, 8192, 1024), 32, True, torch.float32),  # one batch: 512 blocks of 16 rows
    ],
)
def test_group_norm_kernel_matches_plain(cuda, shape, groups, silu, dtype):
    """Kernel #8 against fused_group_norm_ref: f32 sums in other orders, so
    a or b may round the other way; bf16 held to 2 ulps at the largest
    magnitude, f32 to 1e-5 relative. One call is one launch of the
    wrapper (its two passes)."""
    from sliders_tpu_torch.ops import group_norm as tg

    gen = torch.Generator(device=cuda).manual_seed(8)
    x = (torch.randn(shape, generator=gen, device=cuda) * 2 + 0.5).to(dtype)
    gamma = 1.0 + 0.2 * torch.randn(shape[-1], generator=gen, device=cuda)
    beta = 0.3 * torch.randn(shape[-1], generator=gen, device=cuda)
    launches = tg.fused_group_norm.launches
    out = tg.fused_group_norm(x, gamma, beta, groups, 1e-5, silu)
    torch.cuda.synchronize()
    assert tg.fused_group_norm.launches == launches + 1
    ref = tg.fused_group_norm_ref(x, gamma, beta, groups, 1e-5, silu)
    ref_max = ref.float().abs().max().item()
    tol = 2 * _ulps_bf16(ref_max) if dtype == torch.bfloat16 else 1e-5 * max(1.0, ref_max)
    assert out.dtype == dtype and (out.float() - ref.float()).abs().max().item() <= tol
    strided = torch.cat([x, x], dim=-1)[..., : shape[-1]]  # (B, L, C) with row stride 2C
    with pytest.raises(ValueError, match="contiguous"):
        tg.fused_group_norm(strided, gamma, beta, groups)
    with pytest.raises(ValueError, match="contiguous gamma"):
        tg.fused_group_norm(x, torch.stack([gamma, beta], -1)[:, 0], beta, groups)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape,dtype", [((16, 4096, 320), torch.bfloat16),
                                         ((16, 256, 2560), torch.bfloat16),
                                         ((16, 4096, 320), torch.float32)])
def test_group_norm_kernel_is_deterministic(cuda, shape, dtype):
    """Two launches of kernel #8 on the same inputs give the same bits: the
    chunks' partial sums are folded in a fixed order, no atomics."""
    from sliders_tpu_torch.ops import group_norm as tg

    gen = torch.Generator(device=cuda).manual_seed(9)
    x = (torch.randn(shape, generator=gen, device=cuda) * 2 + 0.5).to(dtype)
    gamma = 1.0 + 0.2 * torch.randn(shape[-1], generator=gen, device=cuda)
    beta = 0.3 * torch.randn(shape[-1], generator=gen, device=cuda)
    first = tg.fused_group_norm(x, gamma, beta, 32, 1e-5, True)
    assert torch.equal(first, tg.fused_group_norm(x, gamma, beta, 32, 1e-5, True))


@pytest.mark.requires_cuda
def test_f32_kernel_holds_long_rows_with_outputs_near_one(cuda):
    """#1 in f32 at L = 16384, d = 40 with v = 1 + 0.1 randn, so |o| is
    about 1: o within 1e-5 of |o|max of its plain version. The first pass
    rescales l by the exact 2^(b - b') (1 where the max holds); a factor
    2^(c m - b') of 1 + an ulp taken every tile would drift l, and o with
    it, by about 3e-5 over 512 tiles."""
    gen = torch.Generator(device=cuda).manual_seed(40)
    shape = (1, 2, 16384, 40)
    q, k = (torch.randn(shape, generator=gen, device=cuda) for _ in range(2))
    v = 1.0 + 0.1 * torch.randn(shape, generator=gen, device=cuda)
    out = sa.sd_attention(q, k, v)
    ref = sa.sd_attention_ref(q, k, v)
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    assert scale > 0.5
    assert (out - ref).abs().max().item() <= 1e-5 * scale


@pytest.mark.requires_cuda
@pytest.mark.parametrize(
    "shape,dtype",
    [
        ((1, 2, 2048, 128), torch.bfloat16),  # FLUX's head dim
        ((2, 3, 1024, 256), torch.bfloat16),
        ((1, 16, 4096, 256), torch.bfloat16),  # fills the card
        ((1, 2, 1024, 128), torch.float32),
        ((2, 3, 1024, 256), torch.float32),
        ((1, 16, 4096, 256), torch.float32),  # fills the card
        ((2, 1, 1024, 512), torch.float32),  # the VAE's single-head mid attention
    ],
)
def test_flash_kernel_matches_plain(cuda, shape, dtype):
    """Kernel #4 against flash_attention_ref (128-key blocks, unnormalised p
    rounded to v's dtype): both round p and o at the same points and sum in
    other orders with another exp, so bf16 is held to 4 ulps at the output's
    largest magnitude, f32 to 1e-5. One launch, on the plan of (dtype, d)."""
    from sliders_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype) for _ in range(3))
    launches = fa.flash_attention.launches
    plans = dict(fa.flash_attention.launches_by_plan)
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == launches + 1
    plan = fa.fwd_plan(dtype, shape[3])
    assert {p: n - plans[p] for p, n in fa.flash_attention.launches_by_plan.items()} == {
        p: (1 if p == plan else 0) for p in fa.FWD_PLANS}
    ref = fa.flash_attention_ref(q, k, v)
    ref_max = ref.float().abs().max().item()
    tol = 4 * _ulps_bf16(ref_max) if dtype == torch.bfloat16 else 1e-5
    assert out.shape == ref.shape and out.dtype == dtype
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.requires_cuda
@pytest.mark.parametrize("d,dtype", [(128, torch.bfloat16), (256, torch.bfloat16),
                                     (128, torch.float32), (256, torch.float32)])
def test_flash_kernel_takes_head_strided_views(cuda, d, dtype):
    """(B, L, H*d) projection output viewed as (B, H, L, d); the result is a
    (B, H, L, d) view of a (B, L, H, d) buffer. bf16 within 4 ulps at the
    largest magnitude, f32 within 1e-5."""
    from sliders_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn((2, 1024, 3 * d), generator=gen, device=cuda).to(dtype)
    qh = x.view(2, 1024, 3, d).permute(0, 2, 1, 3)
    out = fa.flash_attention(qh, qh, qh)
    ref = fa.flash_attention_ref(qh, qh, qh)
    assert out.permute(0, 2, 1, 3).is_contiguous()
    tol = 4 * _ulps_bf16(ref.float().abs().max().item()) if dtype == torch.bfloat16 else 1e-5
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.requires_cuda
def test_flash_kernel_refuses_grad_and_bad_shapes(cuda):
    """The backward takes d = 128 and 256: grad at the VAE's d = 512 is
    refused by name; and no fallback: shapes the kernel does not take
    raise (d = 384 has no forward plan)."""
    from sliders_tpu_torch.ops import flash_attention as fa

    q = torch.randn((1, 1, 1024, 512), device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="queue 2, item 3"):
        fa.flash_attention(q, q, q)
    launches = fa.flash_attention.launches
    for shape in ((1, 2, 1000, 128), (1, 2, 1024, 96), (1, 2, 1024, 384)):
        t = torch.randn(shape, device=cuda)
        with pytest.raises(ValueError):
            fa.flash_attention(t, t, t)
    assert fa.flash_attention.launches == launches


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", [(3, 2, 1024, 512), (1, 3, 2048, 512)])
def test_flash_f32_d512_kernel_ragged_grid(cuda, shape):
    """#4's f32 kernel at d = 512 (one block per 64 q rows across all of d)
    on batch and head grids other than the VAE's single head: o within 1e-5
    of the plain version, and its residuals m and l within 1e-5 relative
    (d = 512 is refused under grad, but the kernel writes them as at d =
    128)."""
    from sliders_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(31)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda) for _ in range(3))
    launches = fa.flash_attention.launches
    o, m, l = fa._forward(q, k, v, residuals=True)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == launches + 1
    ro, rm, rl = fa.flash_attention_fwd_ref(q, k, v)
    assert (o - ro).abs().max().item() <= 1e-5
    for a, b in ((m, rm), (l, rl)):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("views", [False, True])
def test_flash_bf16_forward_residuals(cuda, views):
    """#4's bf16 forward on the Hopper mainloop (one pass, 128-key blocks)
    writes m and l equal to flash_attention_fwd_ref's within 1e-5 relative,
    and o within 4 bf16 ulps, on (B, H, L, d) tensors and on head views of
    (B, L, H*d) buffers."""
    from sliders_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(32)
    B, H, L, d = 2, 3, 2048, 128
    if views:
        q, k, v = (_heads(torch.randn((B, L, H * d), generator=gen, device=cuda).bfloat16(), H)
                   for _ in range(3))
    else:
        q, k, v = (torch.randn((B, H, L, d), generator=gen, device=cuda).bfloat16()
                   for _ in range(3))
    launches = fa.flash_attention.launches
    o, m, l = fa._forward(q, k, v, residuals=True)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == launches + 1
    ro, rm, rl = fa.flash_attention_fwd_ref(q, k, v)
    for a, b in ((m, rm), (l, rl)):
        assert a.shape == (B, H, L) and a.dtype == torch.float32
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()
    tol = 4 * _ulps_bf16(ro.float().abs().max().item())
    assert (o.float() - ro.float()).abs().max().item() <= tol


@pytest.mark.requires_cuda
@pytest.mark.parametrize("d,dtype,views", [(256, torch.bfloat16, False),
                                           (256, torch.bfloat16, True),
                                           (128, torch.float32, False),
                                           (128, torch.float32, True),
                                           (256, torch.float32, False),
                                           (256, torch.float32, True)])
def test_flash_forward_residuals_by_plan(cuda, d, dtype, views):
    """#4's bf16 forward at d = 256 (the Hopper mainloop, 64-key tiles) and
    its f32 forwards at d = 128 and 256 (the one-pass 3xTF32 plans) write m
    and l equal to flash_attention_fwd_ref's within 1e-5 relative, and o
    within 4 bf16 ulps (bf16) or 1e-5 (f32), on (B, H, L, d) tensors and on
    head views of (B, L, H*d) buffers."""
    from sliders_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(34)
    B, H, L = 2, 3, 2048
    if views:
        q, k, v = (_heads(torch.randn((B, L, H * d), generator=gen, device=cuda).to(dtype), H)
                   for _ in range(3))
    else:
        q, k, v = (torch.randn((B, H, L, d), generator=gen, device=cuda).to(dtype)
                   for _ in range(3))
    o, m, l = fa._forward(q, k, v, residuals=True)
    torch.cuda.synchronize()
    ro, rm, rl = fa.flash_attention_fwd_ref(q, k, v)
    for a, b in ((m, rm), (l, rl)):
        assert a.shape == (B, H, L) and a.dtype == torch.float32
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()
    tol = 4 * _ulps_bf16(ro.float().abs().max().item()) if dtype == torch.bfloat16 else 1e-5
    assert (o.float() - ro.float()).abs().max().item() <= tol


@pytest.mark.requires_cuda
@pytest.mark.parametrize("d,dtype", [(128, torch.bfloat16), (256, torch.bfloat16),
                                     (128, torch.float32), (256, torch.float32),
                                     (512, torch.float32)])
def test_flash_forward_is_deterministic(cuda, d, dtype):
    """Two launches of #4's forward on the same inputs give the same bits:
    no atomics, and every sum (at d = 256 in f32 the two warpgroups' partial
    S tiles too) in one fixed order."""
    from sliders_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(35)
    q, k, v = (torch.randn((2, 3, 2048, d), generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    first = fa._forward(q, k, v, residuals=True)
    second = fa._forward(q, k, v, residuals=True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("d,dtype,plan", [(128, torch.bfloat16, "sm90"),
                                          (256, torch.bfloat16, "sm90"),
                                          (128, torch.float32, "tf32"),
                                          (256, torch.float32, "tf32"),
                                          (512, torch.float32, "d512")])
def test_flash_fwd_launches_by_plan(cuda, d, dtype, plan):
    """#4's forward counts each launch under its plan: bf16 on the Hopper
    mainloop ("sm90"), f32 d = 128 and 256 on the one-pass 3xTF32 plans
    ("tf32"), f32 d = 512 on flash_fwd_f32_d512 ("d512")."""
    from sliders_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(d + 36)
    q, k, v = (torch.randn((1, 2, 1024, d), generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    before = dict(fa.flash_attention.launches_by_plan)
    fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    after = fa.flash_attention.launches_by_plan
    assert fa.fwd_plan(dtype, d) == plan
    assert {p: after[p] - before[p] for p in after} == {
        p: (1 if p == plan else 0) for p in fa.FWD_PLANS}


@pytest.mark.requires_cuda
def test_flash_function_grads_through_new_forward(cuda):
    """FlashAttention at (1, 2, 2048, 128) bf16: the new forward's output and
    residuals feed #4's dk/dv and dq kernels, and the gradients equal the
    plain route's (autograd through xla_attention) within 16 bf16 ulps at
    the largest magnitude, the tolerance of
    test_flash_function_grads_match_plain_route for the same rounding
    differences."""
    from sliders_tpu_torch.ops import attention as ta
    from sliders_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(33)
    x = [(torch.randn((1, 2, 2048, 128), generator=gen, device=cuda) * 0.5).bfloat16()
         for _ in range(4)]
    q, k, v = (t.clone().requires_grad_() for t in x[:3])
    counts = (fa.flash_attention.launches, fa.flash_attention_bwd.dkv_launches,
              fa.flash_attention_bwd.dq_launches)
    out = fa.flash_attention(q, k, v)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (q, k, v), x[3])
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention_bwd.dkv_launches,
            fa.flash_attention_bwd.dq_launches) == tuple(c + 1 for c in counts)
    qp, kp, vp = (t.clone().requires_grad_() for t in x[:3])
    plain = torch.autograd.grad(ta.xla_attention(qp, kp, vp), (qp, kp, vp), x[3])
    for gk, gp in zip(grads, plain):
        scale = gp.float().abs().max().item()
        assert (gk.float() - gp.float()).abs().max().item() <= 2.0**-6 * max(scale, 1e-6)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    B, L, D = x.shape
    return x.view(B, L, heads, D // heads).permute(0, 2, 1, 3)


@pytest.mark.requires_cuda
@pytest.mark.parametrize(
    "shape,dtype,views",
    [
        ((1, 2, 2048, 128), torch.bfloat16, False),
        ((1, 3, 2048, 128), torch.bfloat16, True),  # head views of (B, L, H*d), as FLUX passes them
        ((2, 3, 2048, 128), torch.bfloat16, True),
        ((2, 2, 1024, 256), torch.bfloat16, False),
        ((2, 3, 1024, 256), torch.bfloat16, True),  # d = 256 on head views
        ((1, 16, 4096, 256), torch.bfloat16, False),  # fills the card
        ((1, 2, 1024, 128), torch.float32, False),
        ((1, 2, 1024, 128), torch.float32, True),
        ((1, 1, 1024, 256), torch.float32, False),
        ((1, 2, 6912, 128), torch.float32, True),  # the tiny f32 FLUX run's 1280 px
        # f32 d = 256 and 512 on the cluster plan: one that fills the card,
        # head views, and the VAE's single head at d = 512
        ((1, 16, 4096, 256), torch.float32, False),
        ((2, 3, 1024, 256), torch.float32, True),
        ((1, 1, 4096, 512), torch.float32, False),
    ],
)
def test_flash_bwd_kernel_matches_plain(cuda, shape, dtype, views):
    """#4's residual forward and its dk/dv and dq kernels against the plain
    versions on the same inputs: m and l within 1e-5 relative (f32 sums in
    another order), o as in the forward test, and dq, dk, dv from the same
    o, m, l against flash_attention_bwd_ref: both round p and ds to the
    input dtype at the same points and sum in other orders with another
    exp, so bf16 is held to 4 ulps at each output's largest magnitude, f32
    to 1e-5 of it."""
    from sliders_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(21)
    B, H, L, d = shape
    if views:
        q, k, v, g = (_heads(torch.randn((B, L, H * d), generator=gen, device=cuda).to(dtype), H)
                      for _ in range(4))
    else:
        q, k, v, g = (torch.randn(shape, generator=gen, device=cuda).to(dtype) for _ in range(4))
    counts = (fa.flash_attention.launches, fa.flash_attention_bwd.dkv_launches,
              fa.flash_attention_bwd.dq_launches)
    o, m, l = fa._forward(q, k, v, residuals=True)
    out = fa.flash_attention_bwd(q, k, v, o, g, m, l)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention_bwd.dkv_launches,
            fa.flash_attention_bwd.dq_launches) == tuple(c + 1 for c in counts)
    ro, rm, rl = fa.flash_attention_fwd_ref(q, k, v)
    for a, b in ((m, rm), (l, rl)):
        assert a.shape == (B, H, L) and (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()
    ref = fa.flash_attention_bwd_ref(q, k, v, o, g, m, l)
    for name, a, r in zip(("dq", "dk", "dv"), out, ref):
        assert a.shape == r.shape and a.dtype == dtype
        ref_max = r.float().abs().max().item()
        tol = 4 * _ulps_bf16(ref_max) if dtype == torch.bfloat16 else 1e-5 * max(1.0, ref_max)
        err = (a.float() - r.float()).abs().max().item()
        assert err <= tol, (name, err, tol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("d,dtype,plan", [(128, torch.bfloat16, "pair"),
                                          (256, torch.bfloat16, "split"),
                                          (128, torch.float32, "tf32"),
                                          (256, torch.float32, "cluster"),
                                          (512, torch.float32, "cluster")])
def test_flash_bwd_launches_by_plan(cuda, d, dtype, plan):
    """#4's backward counts each kernel launch under its plan: bf16 d = 128
    PAIR, d = 256 SPLIT, f32 d = 128 the TF32 plan (3xTF32 `wgmma`) and f32
    d = 256 and 512 the TF32 plan on clusters of blocks that split d."""
    from sliders_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(d + 38)
    q, k, v, g = (torch.randn((1, 2, 1024, d), generator=gen, device=cuda).to(dtype)
                  for _ in range(4))
    o, m, l = fa._forward(q, k, v, residuals=True)
    before = dict(fa.flash_attention_bwd.launches_by_plan)
    fa.flash_attention_bwd(q, k, v, o, g, m, l)
    torch.cuda.synchronize()
    after = fa.flash_attention_bwd.launches_by_plan
    assert {p: after[p] - before[p] for p in after} == {
        p: (2 if p == plan else 0) for p in fa.BWD_PLANS}


@pytest.mark.requires_cuda
@pytest.mark.parametrize(
    "length,heads,dtype,rel_tol,d",
    [
        (6144, 2, torch.float32, 1e-5, 128),  # #4 in f32 from 6144 tokens (FLUX at 1536 px: 9728)
        # bf16: the plain route's autograd rounds dp to bf16 and keeps ds in
        # f32 and normalises p before rounding it, where the kernels keep dp
        # in f32 and round unnormalised p and ds: 16 bf16 ulps at the largest
        (10240, 2, torch.bfloat16, 2.0**-6, 128),
        (9728, 2, torch.float32, 1e-5, 128),  # FLUX at 1536 px, where f32 first routes to #4
        (4096, 2, torch.bfloat16, 2.0**-6, 256),  # bf16 d = 256: the SPLIT backward
    ],
)
def test_flash_function_grads_match_plain_route(cuda, length, heads, dtype, rel_tol, d):
    """A self-attention routed to #4 under grad carries a grad_fn, its
    gradients come from #4's backward kernels reading the new forwards'
    residuals (f32 d = 128: the one-pass 3xTF32 plan; bf16 d = 256: the
    Hopper mainloop at 64-key tiles), and they equal the plain route's
    (autograd through xla_attention)."""
    from sliders_tpu_torch.ops import attention as ta
    from sliders_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(22)
    x = [(torch.randn((1, length, heads * d), generator=gen, device=cuda) * 0.5).to(dtype)
         for _ in range(4)]
    q, k, v = (t.clone().requires_grad_() for t in x[:3])
    counts = (fa.flash_attention.launches, fa.flash_attention_bwd.dkv_launches,
              fa.flash_attention_bwd.dq_launches, sa.sd_attention.launches)
    out = ta.multihead_attention(q, k, v, heads)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (q, k, v), x[3])
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention_bwd.dkv_launches,
            fa.flash_attention_bwd.dq_launches, sa.sd_attention.launches) == (
                counts[0] + 1, counts[1] + 1, counts[2] + 1, counts[3])
    ta.set_attention_impl("xla")
    try:
        qp, kp, vp = (t.clone().requires_grad_() for t in x[:3])
        plain = torch.autograd.grad(ta.multihead_attention(qp, kp, vp, heads), (qp, kp, vp), x[3])
    finally:
        ta.set_attention_impl("auto")
    for gk, gp in zip(grads, plain):
        scale = gp.float().abs().max().item()
        assert (gk.float() - gp.float()).abs().max().item() <= rel_tol * max(scale, 1e-6)


@pytest.mark.requires_cuda
def test_bwd_kernel_at_flux_training_shape(cuda):
    """Kernel #2 at d = 128 on FLUX's 512 px grad-pass shape (1, 24, 1536,
    128), on head views of (B, L, 3072) buffers as models/flux.py passes
    them: within 4 bf16 ulps of sd_attention_bwd_ref at each output's
    largest magnitude."""
    gen = torch.Generator(device=cuda).manual_seed(23)
    q, k, v, g = (_heads(torch.randn((1, 1536, 3072), generator=gen, device=cuda).bfloat16(), 24)
                  for _ in range(4))
    out = sa.sd_attention_bwd(q, k, v, g)
    ref = sa.sd_attention_bwd_ref(q, k, v, g)
    for name, a, r in zip(("dq", "dk", "dv"), out, ref):
        tol = 4 * _ulps_bf16(r.float().abs().max().item())
        assert (a.float() - r.float()).abs().max().item() <= tol, name


@pytest.mark.requires_cuda
def test_tiny_flux_training_step_moves_every_down(cuda):
    """One FLUX training step on the card: a TINY transformer at FLUX's head
    dim 128 in f32 at 1536 px (L = 512 + 96**2 = 9728: #4's route, with
    remat), an xattn ortho-up slider. t_to = 1 of 2 steps: #4's forward
    launches 4 joint attentions x (1 denoise + 1 frozen + 2 grad with remat),
    its backward 4; every down moves, every up and alpha stays bit for bit,
    and the loss is finite."""
    import dataclasses

    from sliders_tpu_torch.diffusion.schedulers import make_flowmatch_sampler
    from sliders_tpu_torch.lora.network import create_slider_network, trainable_mask
    from sliders_tpu_torch.models import flux
    from sliders_tpu_torch.ops import flash_attention as fa
    from sliders_tpu_torch.training import flux_slider, optimizers, text_slider

    cfg = dataclasses.replace(flux.TINY, attention_head_dim=128, axes_dims_rope=(16, 56, 56))
    gen = torch.Generator(device=cuda).manual_seed(24)
    params = flux.init_params(gen, cfg, device=cuda)
    lora = create_slider_network(gen, params, rank=4, train_method="xattn", ortho_up=True,
                                 device=cuda)
    before = {m: {k: t.clone() for k, t in e.items()} for m, e in lora.items()}
    mask = trainable_mask(lora, ortho_up=True)
    tx = optimizers.make_optimizer("adamw", optimizers.make_lr_schedule("constant", 1e-3, 10),
                                   trainable_mask=mask)
    step = flux_slider.make_flux_slider_step(
        cfg, make_flowmatch_sampler(2, image_seq_len=9216), tx, resolution=1536,
        compute_dtype=torch.float32, remat=True, trainable_mask=mask)
    pair = {f"{r}_{k}": torch.randn(shape, generator=gen, device=cuda)
            for r in flux_slider.ROLES
            for k, shape in (("t5", (512, cfg.joint_attention_dim)),
                             ("pooled", (cfg.pooled_projection_dim,)))}
    pair["guidance_signed"] = torch.tensor(1.0, device=cuda)
    pairs = text_slider.stack_prompt_pairs([pair])
    counts = (fa.flash_attention.launches, fa.flash_attention_bwd.dkv_launches,
              fa.flash_attention_bwd.dq_launches)
    state = text_slider.SliderTrainState.create(0, lora, tx)
    state, m = step(state, params, pairs)
    torch.cuda.synchronize()
    assert m["t_to"] == 1 and math.isfinite(m["loss"]) and set(m["phase_ms"]) == {
        "denoise", "frozen", "grad", "update"}
    assert (fa.flash_attention.launches - counts[0], fa.flash_attention_bwd.dkv_launches -
            counts[1], fa.flash_attention_bwd.dq_launches - counts[2]) == (16, 4, 4)
    for name, e in state.lora.items():
        assert not torch.equal(e["down"], before[name]["down"]), name
        assert torch.equal(e["up"], before[name]["up"]) and torch.equal(e["alpha"],
                                                                        before[name]["alpha"])


# ---------------------------------------------------------------------------
# the layout pin #9
# ---------------------------------------------------------------------------


def _pin_input(kind, shape, dtype, device, seed=11):
    """(B, L, C) as the pin may meet it: contiguous (the vector copy), the
    channel-major view of a (B, C, L) buffer (the tile transpose), a slice of
    wider rows (16-byte rows), a slice off the 16-byte grid and a
    batch-expanded row (the gather)."""
    B, L, C = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    if kind == "contiguous":
        return torch.randn(shape, generator=gen, device=device).to(dtype)
    if kind == "channel_major":
        return torch.randn((B, C, L), generator=gen, device=device).to(dtype).transpose(1, 2)
    wide = torch.randn((B, L, C + 16), generator=gen, device=device).to(dtype)
    if kind == "sliced":
        return wide[..., 8:C + 8]
    if kind == "odd_slice":
        return wide[..., 1:C + 1]
    if kind == "expanded":
        return wide[:1, :, :C].expand(B, L, C)
    raise ValueError(kind)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["contiguous", "channel_major", "sliced", "odd_slice",
                                  "expanded"])
@pytest.mark.parametrize("shape,dtype", [((2, 4096, 640), torch.bfloat16),
                                         ((2, 1024, 1280), torch.float32),
                                         ((3, 77, 33), torch.bfloat16),  # ragged tiles
                                         ((1, 1000, 24), torch.float32)])
def test_layout_pin_kernel_matches_plain(cuda, kind, shape, dtype):
    """Bit for bit equal to `layout_pin_ref`, contiguous, one launch."""
    from sliders_tpu_torch.ops import layout_pin as lp

    x = _pin_input(kind, shape, dtype, cuda)
    before = lp.layout_pin_copy.launches
    y = lp.layout_pin_copy(x)
    torch.cuda.synchronize()
    assert lp.layout_pin_copy.launches == before + 1
    ref = lp.layout_pin_ref(x)
    assert y.is_contiguous() and y.dtype == x.dtype and y.shape == x.shape
    assert torch.equal(y.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       ref.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


@pytest.mark.requires_cuda
def test_layout_pin_refuses_what_it_does_not_take(cuda):
    from sliders_tpu_torch.ops import layout_pin as lp

    with pytest.raises(ValueError, match="bf16 or f32"):
        lp.layout_pin_copy(torch.zeros(2, 3, 4, dtype=torch.float16, device=cuda))
    with pytest.raises(ValueError, match=r"\(B, L, C\)"):
        lp.layout_pin_copy(torch.zeros(2, 3, device=cuda))


@pytest.mark.requires_cuda
def test_tiny_xl_unet_grad_with_the_layout_pin(cuda):
    """The tiny SDXL UNet's LoRA gradient (noxattn slider, f32) with the pin
    on equals the gradient with it off (the copy is the identity; 1e-5 of
    the largest value leaves room for the atomics of the nearest-upsample
    backward, which sum in no fixed order), and the kernel ran 8 times
    forward and 7 backward: every
    boundary of the 4 transformers, and the backward wherever a gradient
    flows (the first boundary's input depends on no LoRA factor)."""
    from sliders_tpu_torch.lora.network import create_slider_network
    from sliders_tpu_torch.models import unet2d
    from sliders_tpu_torch.models.params import tree_to
    from sliders_tpu_torch.ops import basic
    from sliders_tpu_torch.ops import layout_pin as lp
    from sliders_tpu_torch.ops.basic import SliderLora

    gen = torch.Generator().manual_seed(12)
    params = tree_to(unet2d.init_params(gen, unet2d.TINY_XL), cuda)
    lora = tree_to(create_slider_network(gen, params, rank=4, train_method="noxattn"), cuda)
    for e in lora.values():
        e["up"] = torch.randn(e["up"].shape, generator=gen).to(cuda) * 0.1
    x = torch.randn((1, 32, 32, 4), generator=gen).to(cuda)
    ctx = torch.randn((1, 7, 32), generator=gen).to(cuda)
    added = {"text_embeds": torch.randn((1, 16), generator=gen).to(cuda),
             "time_ids": torch.tensor([[512.0, 512, 0, 0, 256, 256]], device=cuda)}

    def grads():
        leaves = {m: {k: v.clone().requires_grad_() for k, v in e.items()} for m, e in lora.items()}
        out = unet2d.apply(params, unet2d.TINY_XL, x, 500.0, ctx, added_cond=added,
                           lora=SliderLora(weights=leaves, multiplier=1.0), remat=True)
        flat = [v for e in leaves.values() for k, v in e.items() if k != "alpha"]
        return torch.autograd.grad((out ** 2).mean(), flat)

    plain = grads()
    basic.set_layout_pin(True)
    try:
        before = lp.layout_pin_copy.launches
        pinned = grads()
        torch.cuda.synchronize()
        launched = lp.layout_pin_copy.launches - before
    finally:
        basic.set_layout_pin(False)
    assert launched == 8 + 7
    for a, b in zip(pinned, plain):
        assert (a - b).abs().max().item() <= 1e-5 * max(b.abs().max().item(), 1e-12)


@pytest.mark.requires_cuda
def test_served_decode_sets_its_own_conv_precision(cuda):
    """The served decode (`text2image.decode_images`) takes the same TF32
    flags whatever the process set before it: after cuDNN's TF32 flag is
    set True and after it is set False the images are bit-identical, and
    the flags are as they were afterwards. The decode's floats (the same
    `vae.decode` under `decode_precision`: cuDNN convs in TF32 under conv
    impl 'xla') are held to the plain f32 decode (TF32 off everywhere):
    TF32 keeps 11 bits, so each conv's products round by up to 2^-10 of
    their size, and over the SD decoder's 30-odd convs that compounds to
    under 2^-6 of the output's largest magnitude."""
    from sliders_tpu_torch.models import vae
    from sliders_tpu_torch.ops import basic
    from sliders_tpu_torch.pipelines import text2image as t2i

    assert basic.conv_impl() == "xla"
    gen = torch.Generator(device=cuda).manual_seed(37)
    params = vae.init_params(gen, vae.SD_VAE, device=cuda)
    lat = torch.randn((2, 16, 16, 4), generator=gen, device=cuda)
    saved = torch.backends.cudnn.allow_tf32
    images = []
    try:
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = flag
            images.append(t2i.decode_images(params, vae.SD_VAE, lat))
            assert torch.backends.cudnn.allow_tf32 is flag
            assert torch.backends.cuda.matmul.allow_tf32 is False
        torch.backends.cudnn.allow_tf32 = False
        with torch.inference_mode():
            x = vae.denormalize_latents(vae.SD_VAE, lat).float()
            plain = vae.decode(params, vae.SD_VAE, x)
            with t2i.decode_precision():
                served = vae.decode(params, vae.SD_VAE, x)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert images[0].dtype == torch.uint8 and images[0].shape == (2, 128, 128, 3)
    assert torch.equal(images[0], images[1])
    scale = plain.abs().max().item()
    assert (served - plain).abs().max().item() <= 2.0**-6 * scale
