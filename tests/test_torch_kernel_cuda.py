"""The SD attention kernel against its plain version on a CUDA device.

Skips without a card. On one, run it without the JAX test setup:
    python -m pytest --noconftest -m requires_cuda tests/test_torch_kernel_cuda.py -q
"""

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
