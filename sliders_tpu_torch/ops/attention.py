"""Multi-head attention with routing to the attention kernels
(port of sliders_tpu/ops/attention.py).

`xla_attention` is the plain version and the reference numerics: f32 logits,
f32 softmax, probabilities cast to v.dtype before P.V. `multihead_attention`
routes an unmasked self-attention to one of two hand-written kernels (each
runs its plain version on CPU tensors):

- `ops/flash_attention.flash_attention` (kernel #4) where the JAX package
  takes the stock TPU flash kernel: `fa_supports` holds (L % 128 == 0,
  L >= 1024, d % 128 == 0) and kernel #1's TPU gate `pa_supports` refuses
  (its VMEM plan `pick_block_q` / `_fwd_need`, or d > 128). That is
  `routes_to_flash_kernel`: FLUX's joint attention from 2048 px in bf16
  (1536 px in f32) and the VAE's single-head mid attention (d = 512).
- `ops/sd_attention.sd_attention` (kernel #1) for every other unmasked
  self-attention with L >= 1024 and d <= 128 (`routes_to_sd_kernel`): SD1.5's
  level-0 (L=4096, d=40) and level-1 (L=1024, d=80) self-attentions and
  FLUX's joint attention up to 1536 px in bf16. The TPU plan is not a limit
  of the port's #1, which streams K/V; it is kept here only as the JAX
  package's boundary between its two kernels.

Under grad, a call routed to #1 goes through `sd_attention.SdAttention`,
whose backward on CUDA is the backward kernel #2: `routes_to_sd_bwd_kernel`
documents that gate, which is the forward gate. A call routed to #4 goes
through `flash_attention.FlashAttention`, whose backward is #4's own dk/dv
and dq kernels (d = 128 and 256), as the stock TPU kernel's custom_vjp.

The backward routing differs from the JAX package's, by design: under #1
the JAX package differentiates through kernel #2 only for d >= `BWD_MIN_D`
(96, from a TPU A/B in which d=40 was neutral) and only where #2's TPU VMEM
budget holds (`supports_bwd`, pallas_attention.py:200-218: at FLUX's L =
4608 in bf16, 1024 px training, it needs 14.3 MB of a 13 MiB budget); every
other call takes the XLA VJP of `xla_attention`. No H100 measurement backs
either limit, so the port routes #2 wherever #1 routes (SD1.5's d=40 and 80,
FLUX at 512-1536 px), which rounds p and ds where the TPU kernel does, not
where XLA's VJP does. `chip_smoke.py` records the kernel's and the plain
backward's times (ROADMAP queue 3;
`tests/test_torch_flash_attention.py::test_backward_routing_difference_is_pinned`).

`set_attention_impl` mirrors the JAX package's `set_default_attention_impl`
(`config.tpu.attention`): 'auto' and 'pallas' take the kernel routes where
the gates allow them, 'xla' puts every attention on the plain path. The
JAX package's 'pallas' also sends every call #1 refuses, masked ones
included, to the stock kernel, which drops the mask (ROADMAP queue 3); the
port's 'pallas' keeps the gates of 'auto'.

`AttentionTap` is the JAX package's attention-probability tap (the
reference's prompt-to-prompt controller, ptp_utils.py:173-240): while a tap
is active, every call whose `name` it wants runs the plain path, which
returns the softmax probabilities (B, H, Lq, Lkv) (in v's dtype, as the
JAX package's `_xla_attention_probs`: f32 under f32 compute), and stores
them under that name in call order; every other call keeps its kernel
route.
`ring_context` is not ported yet (ROADMAP queue 1, item 15).
"""

from __future__ import annotations

from typing import Optional

import torch

from sliders_tpu_torch.ops.flash_attention import flash_attention
from sliders_tpu_torch.ops.sd_attention import (MAX_D, sd_attention, sd_attention_probs,
                                                sd_attention_ref)

SD_KERNEL_MIN_SEQ = 1024
# the JAX package's boundary between kernel #1 and the stock flash kernel:
# #1's TPU VMEM plan (sliders_tpu/ops/pallas_attention.py:352-404) and the
# stock kernel's gate (sliders_tpu/ops/flash_attention.py:21-40)
LANES = 128
FWD_VMEM_LIMIT = 15 * 2**20
IMPLS = ("auto", "pallas", "xla")

_impl = "auto"


def set_attention_impl(impl: str) -> None:
    """'auto' | 'pallas' (kernel route where the gates allow) | 'xla' (plain
    path everywhere); process-wide, as in the JAX package."""
    global _impl
    if impl not in IMPLS:
        raise ValueError(f"attention impl must be one of {IMPLS}, got {impl!r}")
    _impl = impl


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


def _fwd_need(block_q: int, lkv: int, itemsize: int) -> int:
    """The TPU's scoped-VMEM need of kernel #1's forward: the f32 score tile
    and double-buffered K/V/Q/O blocks at the input width."""
    return (4 * block_q * lkv + 2 * (2 * itemsize * lkv * LANES)
            + 2 * (2 * itemsize * block_q * LANES))


def pick_block_q(lq: int, lkv: int, itemsize: int) -> int:
    """The largest q block of 512, 256 or 128 that divides lq and fits the
    TPU's VMEM plan (0 if none does)."""
    for b in (512, 256, 128):
        if lq % b == 0 and _fwd_need(b, lkv, itemsize) <= FWD_VMEM_LIMIT:
            return b
    return 0


def pa_supports(q_shape, k_shape, itemsize: int = 2) -> bool:
    """Kernel #1's TPU gate (`pallas_attention.supports`): long self-attention
    with d <= 128 whose K/V fit its VMEM plan."""
    if len(q_shape) != 4:
        return False
    lq, d, lk = q_shape[2], q_shape[3], k_shape[2]
    if lq != lk or lq < SD_KERNEL_MIN_SEQ or d > LANES:
        return False
    return pick_block_q(lq, lk, itemsize) != 0


def fa_supports(q_shape, k_shape) -> bool:
    """The stock flash kernel's gate (`flash_attention.supports`):
    self-attention with L % 128 == 0, L >= 1024 and d % 128 == 0."""
    if len(q_shape) != 4:
        return False
    lq, d, lk = q_shape[2], q_shape[3], k_shape[2]
    return lq == lk and lq % LANES == 0 and lq >= SD_KERNEL_MIN_SEQ and d % LANES == 0


def routes_to_flash_kernel(q_shape, k_shape, mask, itemsize: int = 2) -> bool:
    """Kernel #4's gate, the JAX package's decision for the stock kernel:
    unmasked, `fa_supports`, and refused by #1's TPU gate. It takes every
    d % 128 == 0 as the stock kernel does; the port's kernels take only the
    head dims of `flash_attention.fwd_plan` (bf16 d = 128 / 256, f32 d =
    128 / 256 / 512) and raise on the card for any other, which no model of
    the repository routes."""
    return (mask is None and fa_supports(q_shape, k_shape)
            and not pa_supports(q_shape, k_shape, itemsize=itemsize))


def routes_to_sd_kernel(q_shape, k_shape, mask) -> bool:
    """The SD kernel's gate on (B, H, L, d) shapes: unmasked self-attention
    (L_q == L_kv) of at least SD_KERNEL_MIN_SEQ tokens with d <= 128 and a
    multiple of 8 (the kernel's 16-byte loads). `multihead_attention` asks
    `routes_to_flash_kernel` first."""
    if mask is not None or len(q_shape) != 4:
        return False
    lq, d = q_shape[2], q_shape[3]
    return lq == k_shape[2] and lq >= SD_KERNEL_MIN_SEQ and d <= MAX_D and d % 8 == 0


def routes_to_sd_bwd_kernel(q_shape, k_shape, mask) -> bool:
    """The backward kernel's gate: for now the forward gate (see the module
    docstring for why the JAX package's d >= 96 is not carried over)."""
    return routes_to_sd_kernel(q_shape, k_shape, mask)


_active_tap = None


class AttentionTap:
    """While active (`with AttentionTap(filter_fn) as tap:`), every
    `multihead_attention` call whose `name` the tap wants (`filter_fn(name)`,
    or every named call without a filter) runs the plain path and stores
    its softmax probabilities (B, H, Lq, Lkv) in `tap.store` under the
    call-site path, in call order. Unnamed calls are never tapped. Taps
    nest: leaving one restores the one before."""

    def __init__(self, filter_fn=None):
        self.store: dict = {}
        self.filter_fn = filter_fn

    def __enter__(self):
        global _active_tap
        self._prev = _active_tap
        _active_tap = self
        return self

    def __exit__(self, *exc):
        global _active_tap
        _active_tap = self._prev
        return False

    def wants(self, name) -> bool:
        if name is None:
            return False
        return self.filter_fn is None or bool(self.filter_fn(name))


def multihead_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    name: Optional[str] = None,
) -> torch.Tensor:
    """q: (B, Lq, D); k, v: (B, Lkv, D). Returns (B, Lq, D). `mask` is
    additive, broadcastable to (B, H, Lq, Lkv). `name` is the call-site
    path that an active `AttentionTap` keys its store by."""
    qh, kh, vh = (_split_heads(t, num_heads) for t in (q, k, v))
    if _active_tap is not None and _active_tap.wants(name):
        out, _active_tap.store[name] = sd_attention_probs(qh, kh, vh, mask)
        return _merge_heads(out)
    if _impl != "xla" and routes_to_flash_kernel(qh.shape, kh.shape, mask, qh.element_size()):
        out = flash_attention(qh, kh, vh)
    elif _impl != "xla" and routes_to_sd_kernel(qh.shape, kh.shape, mask):
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
