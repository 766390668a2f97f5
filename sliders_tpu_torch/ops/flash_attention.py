"""Flash attention: the hand-written Hopper kernels and their plain versions
(port of sliders_tpu/ops/flash_attention.py, which calls JAX's stock TPU
flash kernel, a `custom_vjp`).

`flash_attention(q, k, v)` takes (B, H, L, d) tensors. On a CUDA tensor it
launches the forward kernel of its plan (`fwd_plan`) or raises; on a CPU
tensor it runs `flash_attention_ref`, the plain PyTorch version with the TPU
kernel's schedule: 128-key blocks, a running max and sum per row, the
UNNORMALISED probabilities rounded to v's dtype before P.V, and the
accumulator rescaled block by block, all in f32. It rounds at another point
than `sd_attention` (kernel #1), which rounds the normalised probabilities.

When grad mode is on and an input requires grad, the call goes through
`FlashAttention`, a `torch.autograd.Function`. Its forward also keeps each
row's final max m and sum l in f32 (the residuals of the TPU kernel's
`_flash_attention_fwd`), and its backward is `flash_attention_bwd`: on CUDA
the TPU kernel's two backward kernels ported by hand (a K/V-major dk/dv
kernel and a q-major dq kernel, no atomics; bf16 at d = 128 and 256 and
f32 at d = 128, 256 and 512 (three TF32 products for each, after a pass
that splits the streamed operands into TF32 hi and lo planes; at d = 256
and 512 on clusters of d / 128 blocks that split d) on the backward
mainloop of `csrc/attention_bwd_sm90.cuh`), on the CPU
`flash_attention_bwd_ref`, their plain version on the same schedule and
cast points. di = rowsum(o * do) is a torch reduction, as the TPU code takes
it outside its kernels. Under grad `flash_attention` takes d = 128 and 256
(FLUX's joint attention; the VAE's d = 512 mid attention never runs under
grad and is refused there, ROADMAP queue 2, item 3); `flash_attention_bwd`
itself also takes f32 d = 512.

`ops/attention.routes_to_flash_kernel` sends here the shapes the JAX package
sends to the stock kernel: unmasked self-attention with L % 128 == 0,
L >= 1024 and d % 128 == 0 that kernel #1's TPU plan refuses (FLUX's joint
attention from 2048 px in bf16 and 1536 px in f32, and the VAE's single-head
mid attention, d = 512). The forward kernels take such shapes at bf16 d = 128
and 256 (plan "sm90": the Hopper mainloop of `csrc/attention_sm90.cuh`, one
pass), f32 d = 128 and 256 (plan "tf32": the one-pass 3xTF32 plans of
`csrc/attention_fwd_tf32.cuh`, after split passes write k's TF32 hi and lo
planes and v's transposed into a scratch this wrapper allocates) and f32
d = 512 (plan "d512": a kernel that sums each K tile's logits once over all
of d); other head dims raise on CUDA tensors (no model of the repository
routes them; the stock TPU kernel takes any multiple of 128). The library is
built with nvcc at first use into `sliders_tpu_torch/_build/` with the
package's other kernels (`ops/_build.py`).
"""

from __future__ import annotations

import math

import torch

from sliders_tpu_torch.ops import _build
from sliders_tpu_torch.ops.sd_attention import _bhld_buffer, _fwd_scratch_floats, _kernel_layout

BLOCK_K = 128  # the TPU kernel's block_k (BlockSizes.get_default)
BLOCK_Q = 128  # the TPU backward's block_q_dkv / block_q_dq
BWD_HEAD_DIMS = (128, 256)
# the forward's plans ("sm90": attention_sm90.cuh; "tf32": attention_fwd_tf32.cuh;
# "d512": flash_fwd_f32_d512), and the plan of each (dtype, head dim) it takes
FWD_PLANS = ("sm90", "tf32", "d512")
FWD_PLAN_OF = {torch.bfloat16: {128: "sm90", 256: "sm90"},
               torch.float32: {128: "tf32", 256: "tf32", 512: "d512"}}
# the backward's plans (csrc/attention_bwd_sm90.cuh's PAIR, SPLIT, TF32 and
# TF32 on a cluster of blocks that split d), and the plan of each (dtype,
# head dim) the backward takes
BWD_PLANS = ("pair", "split", "tf32", "cluster")
BWD_PLAN_OF = {torch.bfloat16: {128: "pair", 256: "split"},
               torch.float32: {128: "tf32", 256: "cluster", 512: "cluster"}}
LOG2E = 1.4426950408889634  # the kernels' exps are base 2
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    """Plain version with the residuals: (o, m, l), o (B, H, L, d) in q's
    dtype, m and l (B, H, L) f32. The TPU kernel's schedule
    (`_flash_attention_kernel_single_batch`): per 128-key block s = (q k^T
    in f32) * scale, m' = max(m, rowmax s), p = exp(s - m'), l' = rowsum p +
    exp(m - m') l, acc = acc * (exp(m - m') l / l') + (round(p) v in f32) /
    l'; o is acc cast to q's dtype, m and l the last block's."""
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
    return acc.to(q.dtype), m[..., 0], l[..., 0]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version: (B, H, L, d) softmax(q k^T / sqrt(d)) v on the TPU
    kernel's schedule (see `flash_attention_fwd_ref`)."""
    return flash_attention_fwd_ref(q, k, v)[0]


def flash_attention_bwd_ref(q, k, v, o, do, m, l) -> tuple:
    """Plain version of the backward kernels: (dq, dk, dv) for the output
    gradient `do`, from the forward's output o and residuals m, l, on the
    TPU backward's schedule (`_flash_attention_bwd_dkv`,
    `_flash_attention_bwd_dq`): di = rowsum(o * do) in f32; per 128-row q
    block s = (q k^T in f32) * scale, p = exp(s - m) * (1 / l), dv +=
    round(p)^T do, dp = do v^T, ds = ((dp - di) * p) * scale, dk +=
    round(ds)^T q, dq = round(ds) k, where round() casts to do's dtype and
    every product sums in f32; the results are cast to the inputs' dtypes.
    p comes from the final m and l, so no rounding depends on the block
    size; the blocks bound the (128, L) f32 temporaries."""
    scale = q.shape[-1] ** -0.5
    rd = do.dtype
    qf, kf, vf, gf = (t.float() for t in (q, k, v, do))
    di = (o.float() * gf).sum(-1, keepdim=True)
    inv = (1.0 / l.float())[..., None]
    mf = m.float()[..., None]
    dq = torch.empty(qf.shape, device=q.device)
    dk = torch.zeros(kf.shape, device=q.device)
    dv = torch.zeros(vf.shape, device=q.device)
    kt, vt = kf.transpose(-1, -2), vf.transpose(-1, -2)
    for start in range(0, q.shape[2], BLOCK_Q):
        rows = slice(start, start + BLOCK_Q)
        s = torch.matmul(qf[:, :, rows], kt) * scale
        p = torch.exp(s - mf[:, :, rows]) * inv[:, :, rows]
        dv += torch.matmul(p.to(rd).float().transpose(-1, -2), gf[:, :, rows])
        dp = torch.matmul(gf[:, :, rows], vt)
        ds = ((dp - di[:, :, rows]) * p * scale).to(rd).float()
        dk += torch.matmul(ds.transpose(-1, -2), qf[:, :, rows])
        dq[:, :, rows] = torch.matmul(ds, kf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention (kernel #4) takes bf16 or f32 q/k/v of one dtype, got "
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


def fwd_plan(dtype: torch.dtype, d: int) -> str:
    """The plan the forward kernel runs at (dtype, d): bf16 d = 128 and 256
    "sm90" (attention_sm90.cuh, one pass), f32 d = 128 and 256 "tf32" (the
    one-pass 3xTF32 plans of attention_fwd_tf32.cuh), f32 d = 512 "d512".
    Raises ValueError for any other (dtype, d)."""
    plan = FWD_PLAN_OF.get(dtype, {}).get(d)
    if plan is None:
        raise ValueError(f"flash_attention's kernels take bf16 d in "
                         f"{tuple(FWD_PLAN_OF[torch.bfloat16])} and f32 d in "
                         f"{tuple(FWD_PLAN_OF[torch.float32])}, not {dtype} d = {d}")
    return plan


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, residuals: bool) -> tuple:
    """(o, m, l); m and l are None unless `residuals`."""
    if q.device.type == "cpu":
        o, m, l = flash_attention_fwd_ref(q, k, v)
        return (o, m, l) if residuals else (o, None, None)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    _check(q, k, v)
    B, H, Lq, d = q.shape
    plan = fwd_plan(q.dtype, d)
    out = _bhld_buffer(q)
    ml = torch.empty((2, B, H, Lq), dtype=torch.float32, device=q.device) if residuals else None
    # the "tf32" plan's split planes of k and v (transposed)
    scratch = (torch.empty(_fwd_scratch_floats(k), dtype=torch.float32, device=q.device)
               if plan == "tf32" else None)
    lib = _build.library("flash")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if ml is None else ml.data_ptr(), None if scratch is None else scratch.data_ptr(),
            B, H, Lq, k.shape[2], d, _DTYPES[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            d ** -0.5, stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    flash_attention.launches_by_plan[plan] += 1
    return (out, ml[0], ml[1]) if residuals else (out, None, None)


def _bwd_scratch_floats(q: torch.Tensor, k: torch.Tensor) -> int:
    """Floats of the backward's scratch: di, m log2(e) and 1 / l, (B, H, Lq)
    each, and in f32 (the TF32 plans) the hi and lo planes of the two
    tensors a kernel streams (q and do, then k and v, in the same room)."""
    B, H, Lq, d = q.shape
    n = 3 * B * H * Lq
    if q.dtype == torch.float32:
        n += 4 * B * H * max(Lq, k.shape[2]) * d
    return n


def bwd_plan(dtype: torch.dtype, d: int) -> str:
    """The plan the backward kernels run at (dtype, d): bf16 d = 128 "pair",
    d = 256 "split", f32 d = 128 "tf32" (3xTF32), f32 d = 256 and 512
    "cluster" (3xTF32 on clusters of d / 128 blocks that split d). Raises
    ValueError for any other (dtype, d)."""
    plan = BWD_PLAN_OF.get(dtype, {}).get(d)
    if plan is None:
        raise ValueError(f"flash_attention_bwd's kernels take bf16 d in "
                         f"{tuple(BWD_PLAN_OF[torch.bfloat16])} and f32 d in "
                         f"{tuple(BWD_PLAN_OF[torch.float32])}, not {dtype} d = {d}")
    return plan


def flash_attention_bwd(q, k, v, o, do, m, l) -> tuple:
    """(dq, dk, dv) of `flash_attention(q, k, v)` for the output gradient
    `do`, from the forward's output o and residuals m, l; all (B, H, L, d)
    in the input dtype. CUDA tensors launch the dk/dv kernel, then the dq
    kernel, on the current stream; CPU tensors run `flash_attention_bwd_ref`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, do, m, l)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cpu or cuda, not {q.device}")
    _check(q, k, v)
    B, H, Lq, d = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} does not match q {tuple(q.shape)} "
                         f"{q.dtype}")
    plan = bwd_plan(q.dtype, d)
    if not _kernel_layout(do):
        do = do.contiguous()
    stats = [t.float().contiguous() for t in (m, l)]
    if any(t.shape != (B, H, Lq) for t in stats):
        raise ValueError(f"m and l must be (B, H, Lq) = {(B, H, Lq)}")
    # di, then each row's m log2(e) and 1 / l: the form the Hopper dk/dv
    # kernels' exps take, made once per row; in f32 the split planes follow
    scratch = torch.empty(_bwd_scratch_floats(q, k), dtype=torch.float32, device=q.device)
    di = scratch[:3 * B * H * Lq].view(3, B, H, Lq)
    torch.sum(o.float() * do.float(), -1, out=di[0])
    torch.mul(stats[0], LOG2E, out=di[1])
    torch.reciprocal(stats[1], out=di[2])
    dq, dk, dv = _bhld_buffer(q), _bhld_buffer(k), _bhld_buffer(v)
    lib = _build.library("flash")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        for part in (0, 1):  # the dk/dv kernel, then the dq kernel
            rc = lib.flash_attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                stats[0].data_ptr(), stats[1].data_ptr(), di.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                B, H, Lq, k.shape[2], d, _DTYPES[q.dtype], part,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
                *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
                d ** -0.5, stream,
            )
            if rc != 0:
                raise RuntimeError(f"flash_attention_bwd {('dk/dv', 'dq')[part]} kernel launch "
                                   f"failed: CUDA error {rc}")
            if part == 0:
                flash_attention_bwd.dkv_launches += 1
            else:
                flash_attention_bwd.dq_launches += 1
            flash_attention_bwd.launches_by_plan[plan] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """`flash_attention` with a gradient: the forward with residuals and the
    backward kernels on CUDA; on the CPU the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, m, l = _forward(q, k, v, residuals=True)
        ctx.save_for_backward(q, k, v, o, m, l)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors  # once: under remat each unpack recomputes
        return flash_attention_bwd(q, k, v, o, do, m, l)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, L, d) non-causal attention with 1/sqrt(d) scaling.

    CPU tensors run the plain version. CUDA tensors launch the kernel on the
    current stream; the result is a (B, H, L, d) view of a (B, L, H, d)
    buffer, so merging heads afterwards needs no copy. When grad mode is on
    and an input requires grad, the result carries a gradient through
    `FlashAttention` (d = 128 or 256)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if q.shape[-1] not in BWD_HEAD_DIMS:
            raise NotImplementedError(
                f"the flash-attention backward takes head dims {BWD_HEAD_DIMS}, not "
                f"{q.shape[-1]} (ROADMAP queue 2, item 3)")
        return FlashAttention.apply(q, k, v)
    return _forward(q, k, v, residuals=False)[0]


# kernel launches since the last reset; the counts prove a run went through
# the kernels (calls on CPU tensors never reach them)
flash_attention.launches = 0
flash_attention.launches_by_plan = dict.fromkeys(FWD_PLANS, 0)
flash_attention_bwd.dkv_launches = 0
flash_attention_bwd.dq_launches = 0
flash_attention_bwd.launches_by_plan = dict.fromkeys(BWD_PLANS, 0)  # both kernels, by plan
