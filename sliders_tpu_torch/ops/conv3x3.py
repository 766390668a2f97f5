"""3x3 stride-1 SAME convolutions on NHWC activations: the hand-written Hopper
kernels #5-#7 and their plain versions (counterpart of
sliders_tpu/ops/pallas_conv.py).

  conv3x3(x, w, b)                          kernel #5: conv + bias
  epi_conv3x3(x, w, b, extra, mode)         kernel #7: conv + bias + epilogue
  fused_conv3x3(x, a, s, w, b, extra, mode) kernel #6: silu(x*a + s), then #7

x is (B, H, W, C) with contiguous channels (any batch/row/column strides);
w is the port's OIHW (N, C, 3, 3) laid out channels_last, (N, 3, 3, C) in
memory: the one layout `models.params` gives every conv weight, where it
draws them and where it moves them to a device; b is (N,). `mode` names the
epilogue as the TPU kernels do: 'none', 'temb' (extra is a (B, N) row added
to every pixel, ResnetBlock2D's conv1) or 'residual' (extra is (B, H, W, N),
conv2). In #6, x is the raw pre-GroupNorm input and a, s are the (B, C) f32
fold of GN's statistics and affine (`ops/basic.group_norm_affine`).

On a CUDA tensor each wrapper launches its kernel (`csrc/conv3x3.cu`) on
the current stream or raises: a layout the kernel does not take (channels
not contiguous, a weight that is not channels_last) is an error, never a
quiet copy. Which of the library's two kernels runs is chosen by `plan`
from the shape, strides and addresses alone: the Hopper mainloop
(`csrc/conv3x3_sm90.cuh`, variant 'hopper') for every call TMA can take,
bf16, f16 (`precision: fp16`, on bf16's plans with f16 operands) and f32,
the simple implicit GEMM (variant 'generic', bf16, f16 and f32) for the
rest.
In f32 the Hopper mainloop runs three TF32 products a step on each
operand's TF32 hi and lo parts (3xTF32), within the f32 plain version's
1e-5; the wrapper first splits the weight with the `tf32_split` kernel
(plain version `tf32_split_ref`), one launch per f32 call, counted on
`tf32_split`. Each conv wrapper counts its launches, and beside them its
launches by variant (`fn.variants`).
On a CPU tensor it runs the plain version (`*_ref`): the same function at
the kernels' rounding points, f32 accumulation, bias and epilogue added in
f32, one rounding to the input dtype; #6 rounds silu(x*a + s) to the input
dtype before the product, and its zero padding lies in the normalised space.

When grad mode is on and an input requires grad, a call goes through a
`torch.autograd.Function` that mirrors the JAX package's `custom_vjp`s
(`pallas_conv.py:161-187, 373-394, 519-534`): the forward is the kernel,
the backward is autograd through the plain formula in the input dtype (the
JAX VJPs' `_epi_ref` / `_fused_ref`; cuDNN's conv backward on the card),
since the JAX package has no backward kernel here. It returns a gradient
for every input that needs one; in #6 that includes a and s, which carry
the part of dx that flows through GroupNorm's statistics.

The gates (`routed`, `epi_supports`, `fused_supports`) keep every shape
condition of the JAX gates: 3x3, stride 1, C >= 64, N >= 128, H*W a
multiple of 8 and H*W >= 256 (the 8x8 bottleneck stays on cuDNN, as it
stays on XLA there). They drop the TPU's VMEM plan (`_pick_tn*`): the kernel
streams its tiles through shared memory, so no image is too large for it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from sliders_tpu_torch.ops import _build

LANES = 128
MODES = {"none": 0, "temb": 1, "residual": 2}
_DTYPES = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}  # the kernels' dtype codes


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------


def _shape_ok(x_shape, w_shape) -> bool:
    """x (B, H, W, C), w OIHW (N, C, kh, kw)."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    N, C, kh, kw = w_shape
    _, H, W, Cx = x_shape
    if (kh, kw) != (3, 3) or Cx != C or C < 64 or N < LANES:
        return False
    return (H * W) % 8 == 0 and H * W >= 256


def routed(x_shape, w_shape, stride: int = 1) -> bool:
    """Kernel #5's gate ('auto'): `pallas_conv.routed` without the VMEM plan."""
    return stride == 1 and _shape_ok(x_shape, w_shape)


def epi_supports(x_shape, w_shape) -> bool:
    """Kernel #7's gate ('fused_ep'): `pallas_conv.epi_supports` without the VMEM plan."""
    return _shape_ok(x_shape, w_shape)


def fused_supports(x_shape, w_shape) -> bool:
    """Kernel #6's gate ('fused'): `pallas_conv.fused_supports` without the VMEM plan."""
    return _shape_ok(x_shape, w_shape)


# ---------------------------------------------------------------------------
# the kernel and its tile plan
# ---------------------------------------------------------------------------

VARIANTS = ("hopper", "generic")
# csrc/conv3x3_sm90.cuh's constants: bytes of a halo pixel's chunk (one
# 128-byte swizzle row: 64 bf16 or 32 f32 channels), halo buffers, the most
# weight stages, the head (barriers, a and s), a block's shared-memory limit
# on the H100
PIX, HALOS, MAX_STAGES, HEAD, SMEM_MAX = 128, 3, 6, 2048, 232_448
SM90_TC = (128, 64, 32, 16, 8)  # output tile columns; rows 128 / TC
SM90_BN = (256, 160, 128)  # output channels a tile: the wgmma widths compiled
PRO_BN = (160, 128)  # #6's: its consumers' 184 registers hold no 64 x 256 accumulator
# f32 (3xTF32), #6 too: a consumer's two f32 accumulators take its
# registers at 128
F32_BN = (128,)
H100_SMS = 132


@dataclass(frozen=True)
class Plan:
    """How one call runs: variant 'hopper' on TR x TC output tiles of BN
    channels with `stages` weight stages and `smem` bytes of shared memory
    a block, or variant 'generic' (the other fields 0)."""

    variant: str
    tr: int = 0
    tc: int = 0
    bn: int = 0
    stages: int = 0
    smem: int = 0


def _halo_pad(tr: int, tc: int) -> int:
    return -(-(tr + 2) * (tc + 2) * PIX // 1024) * 1024


def plan_smem(tr: int, tc: int, bn: int, stages: int, f32: bool = False) -> int:
    """Dynamic shared memory of a Hopper block: 1024 bytes of alignment
    slack, the head, three halo buffers, the weight stages (a box of 128
    bytes x bn a stage; f32 a hi and a lo box)."""
    return 1024 + HEAD + HALOS * _halo_pad(tr, tc) + stages * bn * PIX * (2 if f32 else 1)


def plan(x_shape, n: int, dtype, x_strides=None, aligned: bool = True,
         sms: int = H100_SMS, prologue: bool = False) -> Plan:
    """The kernel and tile plan for x (B, H, W, C) with element strides
    `x_strides` (contiguous when None) and n output channels; `aligned`
    tells whether x, w (and a, s) lie on 16-byte addresses.

    'hopper' takes bf16, f16 and f32 wherever TMA can: C and x's batch, row
    and column strides multiples of 16 bytes (8 bf16 or f16, or 4 f32 elements), the
    addresses aligned, W >= 8. Its tile is the TR x TC (TR TC = 128) of one
    image with the fewest tiles, then the smallest halo ((TR + 2)(TC + 2)
    pixels), then the widest; BN the width with the least time in whole
    waves of `sms` blocks, ceil(tiles / sms) (BN + 64) (64 for a tile's
    fixed costs), then the widest, among the dtype's widths (bf16 and f16 SM90_BN,
    with #6's `prologue` PRO_BN; f32 F32_BN) that leave room for two weight
    stages; as many weight stages as the shared memory holds, at most 6.
    Everything else (other dtypes too) takes 'generic'."""
    B, H, W, C = x_shape
    strides = tuple(x_strides[:3]) if x_strides is not None else (H * W * C, W * C, C)
    vec = {torch.bfloat16: 8, torch.float16: 8, torch.float32: 4}.get(dtype)
    if vec is None or C % vec or any(s % vec for s in strides) or not aligned or W < 8:
        return Plan("generic")
    f32 = dtype == torch.float32

    def mtiles(tc):
        return B * -(-H // (128 // tc)) * -(-W // tc)

    def tile_key(tc):
        tr = 128 // tc
        return (mtiles(tc), -(-H // tr) * -(-W // tc) * (tr + 2) * (tc + 2), -tc)

    tc = min((t for t in SM90_TC if t <= W), key=tile_key)
    tr = 128 // tc

    def room(b):  # weight stages that fit: a box of PIX bytes x b, f32 two
        return (SMEM_MAX - plan_smem(tr, tc, b, 0, f32)) // (b * PIX * (2 if f32 else 1))

    widths = F32_BN if f32 else PRO_BN if prologue else SM90_BN
    bn = min((b for b in widths if room(b) >= 2),
             key=lambda b: (-(-mtiles(tc) * -(-n // b) // sms) * (b + 64), -b))
    stages = min(MAX_STAGES, room(bn))
    return Plan("hopper", tr, tc, bn, stages, plan_smem(tr, tc, bn, stages, f32))


_SMS: dict = {}


def _sms(device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _prologue(x: torch.Tensor, a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """silu(x*a + s) in f32, rounded to x.dtype (the TPU kernel's `pre_ref`)."""
    xa = x.float() * a[:, None, None, :].float() + s[:, None, None, :].float()
    return (xa * torch.sigmoid(xa)).to(x.dtype)


def epi_conv3x3_ref(x, w, b, extra=None, mode: str = "none") -> torch.Tensor:
    """Plain version of kernel #7: conv + bias + temb row or residual, all in
    f32, one rounding to x.dtype."""
    y = _nhwc(F.conv2d(_nchw(x).float(), w.float(), b.float(), padding=1))
    if mode == "temb":
        y = y + extra.float()[:, None, None, :]
    elif mode == "residual":
        y = y + extra.float()
    return y.to(x.dtype)


def conv3x3_ref(x, w, b) -> torch.Tensor:
    """Plain version of kernel #5: conv + bias in f32, one rounding."""
    return epi_conv3x3_ref(x, w, b)


def fused_conv3x3_ref(x, a, s, w, b, extra=None, mode: str = "none") -> torch.Tensor:
    """Plain version of kernel #6: the prologue silu(x*a + s) rounded to
    x.dtype (zero padding after it), then kernel #7's plain version."""
    return epi_conv3x3_ref(_prologue(x, a, s), w, b, extra, mode)


def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """f32 v rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero (`cvt.rna.tf32.f32`), as an f32 whose low 13 bits are zero.
    A NaN is returned as it is (the integer add would turn a small payload
    into inf and -NaN into +0; the card's cvt may give another NaN's bits),
    so the kernels' bits equal these for every input but a NaN."""
    v = v.float().contiguous()
    rounded = ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isnan(v), v, rounded)


def tf32_split_ref(w: torch.Tensor) -> torch.Tensor:
    """Plain version of the `tf32_split` kernel: the (2, N, 3, 3, C) f32
    operand of the f32 Hopper mainloop from the OIHW (N, C, 3, 3) weight,
    hi = tf32_rna(w) then lo = tf32_rna(w - hi) in its (N, 3, 3, C) order
    (w - hi is exact in f32). The kernel gives these bits for every weight
    without a NaN."""
    v = w.float().permute(0, 2, 3, 1)
    hi = tf32_rna(v)
    return torch.stack([hi, tf32_rna(v - hi)])


def tf32_split(w: torch.Tensor) -> torch.Tensor:
    """tf32_split_ref by the `tf32_split` kernel of `csrc/conv3x3.cu` on a
    CUDA tensor (an f32 OIHW weight laid out channels_last; counted in
    `tf32_split.launches`), the plain version on a CPU tensor."""
    if w.device.type == "cpu":
        return tf32_split_ref(w)
    if w.device.type != "cuda" or w.dtype != torch.float32 or w.ndim != 4 or not (
            w.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"tf32_split takes an f32 OIHW weight laid out channels_last on cpu or "
                         f"cuda, got {w.dtype} {tuple(w.shape)} strides {w.stride()} on "
                         f"{w.device}")
    N, C, kh, kw = w.shape
    out = torch.empty((2, N, kh, kw, C), dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        rc = _build.library("conv").tf32_split_launch(
            w.data_ptr(), out.data_ptr(), w.numel(),
            torch.cuda.current_stream(w.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tf32_split kernel launch failed: CUDA error {rc}")
    tf32_split.launches += 1
    return out


def _conv_formula(x, w, b, extra, mode: str) -> torch.Tensor:
    """The JAX VJPs' formula (`_epi_ref`): conv, + bias, + temb or residual,
    each in x.dtype. Autograd through it is the kernels' backward."""
    y = _nhwc(F.conv2d(_nchw(x), w, padding=1)) + b
    if mode == "temb":
        y = y + extra[:, None, None, :]
    elif mode == "residual":
        y = y + extra
    return y


def _fused_formula(x, a, s, w, b, extra, mode: str) -> torch.Tensor:
    """`_fused_ref`: the prologue, then `_conv_formula`."""
    return _conv_formula(_prologue(x, a, s), w, b, extra, mode)


# ---------------------------------------------------------------------------
# launch
# ---------------------------------------------------------------------------


def _check(x, w, b, extra, mode, a, s) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")
    if x.ndim != 4 or w.ndim != 4 or tuple(w.shape[2:]) != (3, 3) or w.shape[1] != x.shape[3]:
        raise ValueError(f"takes NHWC x and OIHW 3x3 w with matching channels, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    B, H, W, _ = x.shape
    N = w.shape[0]
    if tuple(b.shape) != (N,):
        raise ValueError(f"bias {tuple(b.shape)} does not match {N} output channels")
    want = {"none": None, "temb": (B, N), "residual": (B, H, W, N)}[mode]
    if (extra is None) != (want is None) or (extra is not None and tuple(extra.shape) != want):
        raise ValueError(f"mode {mode!r} takes extra of shape {want}, got "
                         f"{None if extra is None else tuple(extra.shape)}")
    if (a is None) != (s is None) or (a is not None and not (
            tuple(a.shape) == tuple(s.shape) == (B, x.shape[3]))):
        raise ValueError("a and s must both be (B, C)")
    for name, t in (("w", w), ("b", b), ("extra", extra), ("a", a), ("s", s)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _launch(fn, x, a, s, w, b, extra, mode: str) -> torch.Tensor:
    """The kernel on CUDA tensors (counted on the wrapper `fn`), the plain
    version on CPU tensors."""
    _check(x, w, b, extra, mode, a, s)
    if x.device.type == "cpu":
        if a is not None:
            return fused_conv3x3_ref(x, a, s, w, b, extra, mode)
        return epi_conv3x3_ref(x, w, b, extra, mode)
    if x.device.type != "cuda":
        raise ValueError(f"the conv kernels run on cpu or cuda, not {x.device}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (w, b) if t is not None) or (
            extra is not None and extra.dtype != x.dtype):
        raise ValueError(f"the conv kernels (#5-#7) take bf16, f16 or f32 x, w, b and extra of "
                         f"one dtype, got "
                         f"{x.dtype}, {w.dtype}, {b.dtype}, "
                         f"{None if extra is None else extra.dtype}")
    if x.stride(3) != 1 or (mode == "residual" and extra.stride(3) != 1) or (
            mode == "temb" and extra.stride(1) != 1):
        raise ValueError(f"the conv kernels need contiguous channels: x strides {x.stride()}, "
                         f"extra strides {None if extra is None else extra.stride()}")
    if not (w.is_contiguous(memory_format=torch.channels_last) and b.is_contiguous()):
        raise ValueError(f"the conv kernels need an OIHW weight laid out channels_last and a "
                         f"contiguous bias, got strides {w.stride()} and {b.stride()}")
    if a is not None and not (a.dtype == s.dtype == torch.float32 and a.is_contiguous()
                              and s.is_contiguous()):
        raise ValueError("the fused conv kernel takes contiguous f32 a and s")
    B, H, W, C = x.shape
    N = w.shape[0]
    y = torch.empty((B, H, W, N), dtype=x.dtype, device=x.device)
    es = (0, 0, 0) if extra is None else (
        (extra.stride(0), 0, 0) if mode == "temb" else extra.stride()[:3])
    ptrs = (x.data_ptr(), w.data_ptr(), b.data_ptr(), 0 if extra is None else extra.data_ptr(),
            0 if a is None else a.data_ptr(), 0 if s is None else s.data_ptr(), y.data_ptr())
    how = plan(x.shape, N, x.dtype, x.stride(), aligned=all(q % 16 == 0 for q in ptrs[:2] + (
        ptrs[4:6] if a is not None else ())), sms=_sms(x.device), prologue=a is not None)
    lib = _build.library("conv")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if how.variant == "hopper":
            if x.dtype == torch.float32:  # the f32 mainloop reads the weight's TF32 split
                split = tf32_split(w)
                ptrs = (ptrs[0], split.data_ptr(), *ptrs[2:])
            rc = lib.conv3x3_sm90_launch(
                *ptrs, B, H, W, C, N, _DTYPES[x.dtype], MODES[mode], int(a is not None),
                *x.stride()[:3], *es, how.tr, how.tc, how.bn, how.stages, how.smem, stream)
        else:
            rc = lib.conv3x3_launch(
                *ptrs, B, H, W, C, N, _DTYPES[x.dtype], MODES[mode], int(a is not None),
                *x.stride()[:3], *es, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed ({how}): CUDA error {rc}")
    fn.launches += 1
    fn.variants[how.variant] += 1
    return y


def _vjp(formula, inputs: tuple, needs: tuple, g: torch.Tensor) -> list:
    """Gradients of `formula(*inputs)` for the output gradient g, for the
    inputs flagged in `needs` (None for the rest)."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(bool(n))
                  for t, n in zip(inputs, needs)]
        wrt = [t for t, n in zip(leaves, needs) if n]
        got = iter(torch.autograd.grad(formula(*leaves), wrt, g) if wrt else ())
        return [next(got) if n else None for n in needs]


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w, b)
        return _launch(conv3x3, x, None, None, w, b, None, "none")

    @staticmethod
    def backward(ctx, g):
        return tuple(_vjp(lambda x, w, b: _conv_formula(x, w, b, None, "none"),
                          ctx.saved_tensors, ctx.needs_input_grad, g))


class _EpiConv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, extra, mode):
        ctx.mode = mode
        ctx.save_for_backward(x, w, b, extra)
        return _launch(epi_conv3x3, x, None, None, w, b, extra, mode)

    @staticmethod
    def backward(ctx, g):
        grads = _vjp(lambda x, w, b, e: _conv_formula(x, w, b, e, ctx.mode),
                     ctx.saved_tensors, ctx.needs_input_grad[:4], g)
        return (*grads, None)


class _FusedConv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, s, w, b, extra, mode):
        ctx.mode = mode
        ctx.save_for_backward(x, a, s, w, b, extra)
        return _launch(fused_conv3x3, x, a, s, w, b, extra, mode)

    @staticmethod
    def backward(ctx, g):
        grads = _vjp(lambda *t: _fused_formula(*t, ctx.mode),
                     ctx.saved_tensors, ctx.needs_input_grad[:6], g)
        return (*grads, None)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kernel #5: 3x3 SAME conv of NHWC x with OIHW w, + b; (B, H, W, N)."""
    if _needs_grad(x, w, b):
        return _Conv3x3.apply(x, w, b)
    return _launch(conv3x3, x, None, None, w, b, None, "none")


def epi_conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                extra: Optional[torch.Tensor] = None, mode: str = "none") -> torch.Tensor:
    """Kernel #7: conv + b + the temb row or the residual (see the module
    docstring for `mode`)."""
    if _needs_grad(x, w, b, extra):
        return _EpiConv3x3.apply(x, w, b, extra, mode)
    return _launch(epi_conv3x3, x, None, None, w, b, extra, mode)


def fused_conv3x3(x: torch.Tensor, a: torch.Tensor, s: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor, extra: Optional[torch.Tensor] = None,
                  mode: str = "none") -> torch.Tensor:
    """Kernel #6: silu(x*a + s) of the raw pre-GN x with the (B, C) f32 GN
    fold a, s, then kernel #7's conv and epilogue."""
    if _needs_grad(x, a, s, w, b, extra):
        return _FusedConv3x3.apply(x, a, s, w, b, extra, mode)
    return _launch(fused_conv3x3, x, a, s, w, b, extra, mode)


# kernel launches since the last reset, in all and by variant (calls on CPU
# tensors never reach the kernels and are not counted)
for _fn in (conv3x3, epi_conv3x3, fused_conv3x3):
    _fn.launches = 0
    _fn.variants = dict.fromkeys(VARIANTS, 0)
tf32_split.launches = 0
