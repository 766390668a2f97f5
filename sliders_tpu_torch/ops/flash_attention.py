"""Flash attention: the hand-written Hopper kernel and its plain version
(port of sliders_tpu/ops/flash_attention.py, which calls JAX's stock TPU
flash kernel).

`flash_attention(q, k, v)` takes (B, H, L, d) tensors. On a CUDA tensor it
launches the kernel in `csrc/flash_attention.cu` or raises; on a CPU tensor
it runs `flash_attention_ref`, the plain PyTorch version with the TPU
kernel's schedule: 128-key blocks, a running max and sum per row, the
UNNORMALISED probabilities rounded to v's dtype before P.V, and the
accumulator rescaled block by block, all in f32. It rounds at another point
than `sd_attention` (kernel #1), which rounds the normalised probabilities.

`ops/attention.routes_to_flash_kernel` sends here the shapes the JAX package
sends to the stock kernel: unmasked self-attention with L % 128 == 0,
L >= 1024 and d % 128 == 0 that kernel #1's TPU plan refuses (FLUX's joint
attention from 2048 px in bf16 and 1536 px in f32, and the VAE's single-head
mid attention, d = 512). The kernel takes any such shape, in bf16 or f32.

The backward (the stock kernel's dq and dk/dv kernels) comes with FLUX
training (ROADMAP queue 1, item 11): an input that requires grad is refused.
The library is built with nvcc at first use into `sliders_tpu_torch/_build/`
with the package's other kernels (`ops/_build.py`).
"""

from __future__ import annotations

import math

import torch

from sliders_tpu_torch.ops import _build
from sliders_tpu_torch.ops.sd_attention import _bhld_buffer, _kernel_layout

BLOCK_K = 128  # the TPU kernel's block_k (BlockSizes.get_default)
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version: (B, H, L, d) softmax(q k^T / sqrt(d)) v on the TPU
    kernel's schedule (`_flash_attention_kernel_single_batch`): per 128-key
    block s = (q k^T in f32) * scale, m' = max(m, rowmax s), p = exp(s - m'),
    l' = rowsum p + exp(m - m') l, acc = acc * (exp(m - m') l / l') +
    (round(p) v in f32) / l'; the result is acc cast to q's dtype."""
    scale = q.shape[-1] ** -0.5
    qf = q.float()
    B, H, Lq, d = q.shape
    m = torch.full((B, H, Lq, 1), -math.inf, device=q.device)
    l = torch.zeros((B, H, Lq, 1), device=q.device)
    acc = torch.zeros((B, H, Lq, v.shape[-1]), device=q.device)
    for start in range(0, k.shape[2], BLOCK_K):
        kb, vb = k[:, :, start:start + BLOCK_K], v[:, :, start:start + BLOCK_K]
        s = torch.matmul(qf, kb.float().transpose(-1, -2)) * scale
        m_next = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_next)
        l_corr = torch.exp(m - m_next) * l
        l_next = p.sum(-1, keepdim=True) + l_corr
        inv = torch.where(l_next == 0.0, 1.0, 1.0 / l_next)
        acc = acc * (l_corr * inv) + torch.matmul(p.to(v.dtype).float(), vb.float()) * inv
        m, l = m_next, l_next
    return acc.to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention takes bf16 or f32 q/k/v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes (B, H, L, d) q/k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Lq, d = q.shape
    if k.shape[0] != B or k.shape[1] != H or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree")
    if d % 128 or Lq % BLOCK_K or k.shape[2] % BLOCK_K or Lq == 0 or k.shape[2] == 0:
        raise ValueError(f"flash_attention takes L % {BLOCK_K} == 0 and d % 128 == 0, got "
                         f"Lq {Lq}, Lk {k.shape[2]}, d {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _kernel_layout(t):
            raise ValueError(f"{name} needs a contiguous last dim and strides that are "
                             f"multiples of 8 on a 16-byte aligned base, got {t.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, L, d) non-causal attention with 1/sqrt(d) scaling.

    CPU tensors run the plain version. CUDA tensors launch the kernel on the
    current stream; the result is a (B, H, L, d) view of a (B, L, H, d)
    buffer, so merging heads afterwards needs no copy. Inputs that require
    grad are refused: the backward comes with FLUX training."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError(
            "the flash-attention backward (the stock TPU kernel's dq/dkv kernels) is not "
            "ported yet: it comes with FLUX training (ROADMAP queue 1, item 11)"
        )
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    _check(q, k, v)
    B, H, Lq, d = q.shape
    out = _bhld_buffer(q)
    lib = _build.library("flash")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, Lq, k.shape[2], d, _DTYPES[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            d ** -0.5, stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out


# kernel launches since the last reset; the counts prove a run went through
# the kernel (calls on CPU tensors never reach it)
flash_attention.launches = 0
