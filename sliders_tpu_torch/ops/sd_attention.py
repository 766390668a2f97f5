"""SD self-attention: the hand-written Hopper kernels and their plain versions.

`sd_attention(q, k, v)` takes (B, H, L, d) tensors. On a CUDA tensor it
launches the forward kernel in `csrc/sd_attention.cu` or raises; on a CPU
tensor it runs `sd_attention_ref`, the plain PyTorch version with the
numerics of `ops/attention.xla_attention` (f32 logits and softmax,
probabilities cast to the input dtype before P.V).

When grad mode is on and an input requires grad, the call goes through
`SdAttention`, a `torch.autograd.Function`: its forward is the same kernel
(or plain version), and its backward on CUDA is the backward kernel in
`csrc/sd_attention_bwd.cu` (`sd_attention_bwd`). On CPU tensors the backward
is autograd through `sd_attention_ref`, as the JAX package differentiates
`xla_attention` off the TPU (`pallas_attention.py:129-133`).
`sd_attention_bwd_ref` is the backward kernel's plain version: the explicit
formula at the kernel's rounding points, used by the tests and
`chip_smoke.py` to hold the kernel to.

The forward kernel replaces `sliders_tpu/ops/pallas_attention.py::_attn_kernel`
and the backward kernel `_attn_bwd_kernel`. The forward streams K twice and
V once per 128-row q tile: pass 1 finds each row's softmax max and sum, pass
2 forms the normalised probabilities, rounds them to the input dtype (the
TPU kernel's rounding point) and multiplies by V. In bf16 and f16 it runs
on the Hopper mainloop of `csrc/attention_sm90.cuh` (a producer warpgroup
filling a K/V ring by TMA or cp.async, wgmma on two consumer warpgroups;
f16 on the same plans with f16 operands, as `precision: fp16` computes).
The bf16 and f16 backwards run on the backward mainloop of
`csrc/attention_bwd_sm90.cuh` on the same ring: a dq kernel that first
finds each row's softmax statistics, then a dk/dv kernel, no atomics; f16
at the head dims `F16_BWD_DIMS` (the UNets' d = 40, 64 and 80, and 128), any
other f16 head dim raises. In f32 both take every product as three
TF32 `wgmma`s (error-compensated TF32), after a pass that splits their
streamed operands into TF32 hi and lo planes in a scratch the wrapper
allocates: the forward splits k, and v transposed (its own two-pass kernel
in `csrc/sd_attention.cu`); the backward q, k, v and g, on the same
backward mainloop. The source files carry the details.

Both libraries are built with nvcc at first use into
`sliders_tpu_torch/_build/` together with the package's other kernels
(`ops/_build.py`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from sliders_tpu_torch.ops import _build

MAX_D = 128
# the kernels' dtype codes
_DTYPES = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}
# the head dims of the f16 backward's instantiations
F16_BWD_DIMS = (40, 64, 80, 128)


def sd_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain version, and the port's plain attention path
    (`ops/attention.xla_attention`): (B, H, L, d) softmax(q k^T / sqrt(d)) v
    with f32 logits and softmax (plus an additive `mask`), probabilities cast
    to v.dtype before the product."""
    return sd_attention_probs(q, k, v, mask)[0]


def sd_attention_probs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> tuple:
    """`sd_attention_ref` returning (out, probs): the probabilities
    (B, H, Lq, Lkv) as they enter the product, in v.dtype (the JAX
    package's `_xla_attention_probs`)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v), probs


def sd_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         g: torch.Tensor) -> tuple:
    """Plain version of the backward kernel: (dq, dk, dv) of `sd_attention`
    for the output gradient g, at the TPU kernel's cast points
    (`pallas_attention.py:164-186`): p in f32, dv = round(p)^T g,
    dp = g v^T in f32, dsum = rowsum(dp * p) with p unrounded,
    ds = round(p (dp - dsum)), dq = scale ds k, dk = scale ds^T q; products
    accumulate in f32 and the results are cast to the input dtype."""
    dtype = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(p.to(dtype).float().transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    dsum = (dp * p).sum(dim=-1, keepdim=True)
    ds = (p * (dp - dsum)).to(dtype).float()
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"sd_attention takes bf16, f16 or f32 q/k/v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"sd_attention takes (B, H, L, d) q/k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, d = q.shape
    if k.shape[0] != B or k.shape[1] != H or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree")
    if d % 8 or not 8 <= d <= MAX_D:
        raise ValueError(f"head dim {d} must be a multiple of 8 in [8, {MAX_D}]")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _kernel_layout(t):
            raise ValueError(f"{name} needs a contiguous last dim and strides that are "
                             f"multiples of 8 on a 16-byte aligned base, got {t.stride()}")


def _kernel_layout(t: torch.Tensor) -> bool:
    """Whether the kernels can read `t` as it lies: contiguous last dim,
    other strides multiples of 8 elements, 16-byte aligned base."""
    return t.stride(3) == 1 and not any(s % 8 for s in t.stride()[:3]) and t.data_ptr() % 16 == 0


def _bhld_buffer(like: torch.Tensor) -> torch.Tensor:
    """An empty (B, H, L, d) view of a (B, L, H, d) buffer, so that merging
    heads afterwards needs no copy."""
    B, H, L, d = like.shape
    return torch.empty((B, L, H, d), dtype=like.dtype, device=like.device).permute(0, 2, 1, 3)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if q.device.type == "cpu":
        return sd_attention_ref(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"sd_attention runs on cpu or cuda, not {q.device}")
    _check(q, k, v)
    B, H, Lq, d = q.shape
    Lk = k.shape[2]
    out = _bhld_buffer(q)
    scratch = (torch.empty(_fwd_scratch_floats(k), dtype=torch.float32, device=q.device)
               if q.dtype == torch.float32 else None)
    lib = _build.library("fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.sd_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            B, H, Lq, Lk, d, _DTYPES[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            1.0 / math.sqrt(d), stream,
        )
    if rc != 0:
        raise RuntimeError(f"sd_attention kernel launch failed: CUDA error {rc}")
    sd_attention.launches += 1
    return out


def _fwd_scratch_floats(k: torch.Tensor) -> int:
    """Floats of the f32 forward's scratch: the TF32 hi and lo planes of k,
    (B, H, Lk, d) each, and of v transposed, (B, H, d, Lk rounded up to 8)
    each, that its split pass writes."""
    B, H, Lk, d = k.shape
    return 2 * B * H * d * (Lk + -(-Lk // 8) * 8)


def _scratch_floats(q: torch.Tensor, k: torch.Tensor) -> int:
    """Floats of the backward kernels' scratch: each q row's softmax max,
    sum and dsum (3 planes of (B, H, Lq rounded up to 128)), and in f32 the
    hi and lo TF32 planes of q, g, k and v that the split pass writes."""
    B, H, Lq, d = q.shape
    n = 3 * B * H * (-(-Lq // 128) * 128)
    if q.dtype == torch.float32:
        n += 4 * B * H * (Lq + k.shape[2]) * d
    return n


def sd_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     g: torch.Tensor) -> tuple:
    """(dq, dk, dv) of `sd_attention(q, k, v)` for the output gradient g, all
    (B, H, L, d) in the input dtype. CUDA tensors launch the backward kernel
    (in f32 the TF32 split pass, then a dq kernel, then a dk/dv kernel, on
    the current stream); CPU tensors run `sd_attention_bwd_ref`."""
    if q.device.type == "cpu":
        return sd_attention_bwd_ref(q, k, v, g)
    if q.device.type != "cuda":
        raise ValueError(f"sd_attention_bwd runs on cpu or cuda, not {q.device}")
    _check(q, k, v)
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} does not match q {tuple(q.shape)} {q.dtype}")
    if q.dtype == torch.float16 and q.shape[3] not in F16_BWD_DIMS:
        raise ValueError(f"sd_attention_bwd (kernel #2) takes float16 at head dims "
                         f"{F16_BWD_DIMS}, not d = {q.shape[3]}")
    if not _kernel_layout(g):
        g = g.contiguous()
    B, H, Lq, d = q.shape
    Lk = k.shape[2]
    dq, dk, dv = _bhld_buffer(q), _bhld_buffer(k), _bhld_buffer(v)
    stats = torch.empty(_scratch_floats(q, k), dtype=torch.float32, device=q.device)
    lib = _build.library("bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.sd_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            B, H, Lq, Lk, d, _DTYPES[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *g.stride()[:3],
            *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
            1.0 / math.sqrt(d), stream,
        )
    if rc != 0:
        raise RuntimeError(f"sd_attention_bwd kernel launch failed: CUDA error {rc}")
    sd_attention_bwd.launches += 1
    return dq, dk, dv


class SdAttention(torch.autograd.Function):
    """`sd_attention` with a gradient: the forward kernel and the backward
    kernel on CUDA; on the CPU the plain version and autograd through it."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        if q.device.type != "cpu":
            return sd_attention_bwd(q, k, v, g)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            return torch.autograd.grad(sd_attention_ref(*leaves), leaves, g)


def sd_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, L, d) non-causal attention with 1/sqrt(d) scaling.

    CPU tensors run the plain version. CUDA tensors launch the kernel on the
    current stream; the result is a (B, H, L, d) view of a (B, L, H, d)
    buffer, so merging heads afterwards needs no copy. When grad mode is on
    and an input requires grad, the result carries a gradient through
    `SdAttention`."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return SdAttention.apply(q, k, v)
    return _forward(q, k, v)


# kernel launches since the last reset; the counts prove a run went through
# the kernels (calls on CPU tensors never reach them)
sd_attention.launches = 0
sd_attention_bwd.launches = 0
