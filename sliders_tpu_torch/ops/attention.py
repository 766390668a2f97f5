"""Multi-head attention with routing to the SD attention kernel
(port of sliders_tpu/ops/attention.py).

`xla_attention` is the plain version and the reference numerics: f32 logits,
f32 softmax, probabilities cast to v.dtype before P.V. `multihead_attention`
routes every unmasked self-attention with L_q == L_kv >= 1024 and d <= 128
to `ops/sd_attention.sd_attention` (the hand-written kernel on CUDA tensors,
its plain version on CPU tensors), which at SD1.5 512 px are the level-0
(L=4096, d=40) and level-1 (L=1024, d=80) self-attentions. The TPU gate's
VMEM-fit condition (`pick_block_q`, `_fwd_need`) is dropped: the kernel
streams K/V through shared memory, so no sequence length is too long for it.

`AttentionTap` and `ring_context` are not ported yet (ROADMAP queue 1,
items 10 and 15).
"""

from __future__ import annotations

from typing import Optional

import torch

from sliders_tpu_torch.ops.sd_attention import MAX_D, sd_attention, sd_attention_ref

SD_KERNEL_MIN_SEQ = 1024


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, H*d) -> (B, H, L, d) view (no copy)."""
    B, L, D = x.shape
    return x.view(B, L, num_heads, D // num_heads).permute(0, 2, 1, 3)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, L, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(B, L, H * d)


# (B, H, L, d) attention with f32 logits and softmax and an optional additive
# mask: the JAX package's reference numerics, shared with the kernel's
# plain version
xla_attention = sd_attention_ref


def routes_to_sd_kernel(q_shape, k_shape, mask) -> bool:
    """The SD kernel's gate on (B, H, L, d) shapes: unmasked self-attention
    (L_q == L_kv) of at least SD_KERNEL_MIN_SEQ tokens with d <= 128 and a
    multiple of 8 (the kernel's 16-byte loads)."""
    if mask is not None or len(q_shape) != 4:
        return False
    lq, d = q_shape[2], q_shape[3]
    return lq == k_shape[2] and lq >= SD_KERNEL_MIN_SEQ and d <= MAX_D and d % 8 == 0


def multihead_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q: (B, Lq, D); k, v: (B, Lkv, D). Returns (B, Lq, D). `mask` is
    additive, broadcastable to (B, H, Lq, Lkv)."""
    qh, kh, vh = (_split_heads(t, num_heads) for t in (q, k, v))
    if routes_to_sd_kernel(qh.shape, kh.shape, mask):
        out = sd_attention(qh, kh, vh)
    else:
        out = xla_attention(qh, kh, vh, mask)
    return _merge_heads(out)


def causal_mask(length: int, device=None) -> torch.Tensor:
    """Additive causal mask (1, 1, L, L) in f32."""
    mask = torch.triu(
        torch.full((length, length), torch.finfo(torch.float32).min, device=device), diagonal=1
    )
    return mask[None, None]
