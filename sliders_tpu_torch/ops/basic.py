"""Functional compute primitives with LoRA hooks (port of sliders_tpu/ops/basic.py).

Parameters are torch layouts: linear ``weight`` (out, in), conv ``weight``
OIHW, optional ``bias`` (out,). Activations keep the JAX package's NHWC at
the public functions; a conv runs on the NCHW view of an NHWC tensor, which
is channels_last in memory, so no copy is made on the way in or out.

Every linear/conv call site takes an optional ``(lora, name)`` pair; when the
name is in ``lora.weights`` the low-rank branch
``out += multiplier * (alpha / rank) * up(down(x))`` is added. LoRA factors
are torch layouts too: linear down (r, in), up (out, r); conv down
(r, in, kh, kw), up (out, r, 1, 1). A per-row STACKED tree (lora/batch.py)
carries a leading row axis on every leaf, and row b of the batch gets row
b's adapter. Under a tensor-parallel mesh a linear takes its shard of the
weight and the matching slice of a whole LoRA (`linear(..., tp=...)`).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn.functional as F

from sliders_tpu_torch.ops import conv3x3
from sliders_tpu_torch.ops.layout_pin import LayoutPin
from sliders_tpu_torch.parallel.collectives import TPShard, reduce_from_tp, shard_slice


@dataclass
class SliderLora:
    """LoRA weights {lora_name: {'down', 'up', 'alpha'[, 'rank']}} plus the
    slider multiplier: a float, a 0-d tensor, or a (B,) tensor of per-row
    scales."""

    weights: dict
    multiplier: Union[float, torch.Tensor]


def _lora_entry(lora: Optional[SliderLora], name: Optional[str]):
    if lora is None or name is None:
        return None
    return lora.weights.get(name)


def _lora_scale(multiplier, alpha, rank, y: torch.Tensor) -> torch.Tensor:
    """multiplier * alpha / rank, shaped to broadcast over `y`'s rows and
    cast to y.dtype. `rank` is an int for a solo adapter or the (B,)
    true-rank vector of a rank-padded stacked tree."""
    m = torch.as_tensor(multiplier, dtype=torch.float32, device=y.device)
    scale = m * alpha.to(torch.float32) / rank
    if scale.ndim > 0:
        scale = scale.reshape(scale.shape + (1,) * (y.ndim - 1))
    return scale.to(y.dtype)


def linear(
    p: dict,
    x: torch.Tensor,
    *,
    lora: Optional[SliderLora] = None,
    name: Optional[str] = None,
    tp: Optional[TPShard] = None,
) -> torch.Tensor:
    """y = x W^T (+ b) (+ LoRA branch), in x.dtype.

    With `tp` (`parallel.collectives.tp_shard`) `p` holds this rank's shard
    and the LoRA is whole: 'col' applies the rows of `up` that match the
    shard's output features; 'row' applies the columns of `down` that
    match its input features, adds the LoRA's partial product to the base
    partial, all-reduces the sum over tp once, and adds the bias after."""
    bias = p.get("bias")
    row = tp is not None and tp.mode == "row"
    y = F.linear(x, p["weight"].to(x.dtype),
                 None if bias is None or row else bias.to(x.dtype))
    entry = _lora_entry(lora, name)
    if entry is not None:
        down, up = entry["down"].to(x.dtype), entry["up"].to(x.dtype)
        rank = entry.get("rank", down.shape[-2])
        scale = _lora_scale(lora.multiplier, entry["alpha"], rank, y)
        if tp is not None and tp.mode == "col":
            up = shard_slice(up, up.ndim - 2, tp.index, tp.size, parts=tp.parts)
        elif row:
            down = shard_slice(down, down.ndim - 1, tp.index, tp.size, parts=tp.parts)
        if down.ndim == 3:
            # per-row stacked: down (B, r, in), up (B, out, r); x (B, ..., in)
            h = torch.einsum("b...i,bri->b...r", x, down)
            y = y + torch.einsum("b...r,bor->b...o", h, up) * scale
        else:
            y = y + F.linear(F.linear(x, down), up) * scale
    if row:
        y = reduce_from_tp(y, tp.mesh)
        if bias is not None:
            y = y + bias.to(x.dtype)
    return y


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


CONV_IMPLS = (
    "auto", "xla", "interpret",
    "fused", "fused_interpret",
    "fused_ep", "fused_ep_interpret",
)
_conv_impl = "xla"


def conv_impl() -> str:
    return _conv_impl


def set_conv_impl(impl: str) -> None:
    """Route the UNet's 3x3 convs through the conv kernels (`ops/conv3x3.py`),
    process-wide, as the JAX package's `set_conv_impl` does:

    - 'xla' (default): cuDNN everywhere;
    - 'auto': every conv2d that passes `conv3x3.routed` (3x3, stride 1,
      C >= 64, N >= 128, H*W >= 256) goes through kernel #5, then its LoRA
      tail as on the plain path;
    - 'fused_ep': each ResnetBlock2D conv without LoRA that passes
      `epi_supports` takes kernel #7 (bias + temb row / residual epilogue)
      after the plain GroupNorm + SiLU (`models/unet2d._resnet`);
    - 'fused': a ResnetBlock2D whose two convs pass `fused_supports` and
      carry no LoRA takes `group_norm_affine` and kernel #6 twice.

    The '*_interpret' names are the JAX package's CPU test hooks; here each
    behaves as its base name, because a CPU tensor runs the kernels' plain
    versions anyway. Any other name is a ValueError. Takes effect on the
    next call."""
    global _conv_impl
    if impl not in CONV_IMPLS:
        raise ValueError(f"conv impl must be one of {CONV_IMPLS}, got {impl!r}")
    _conv_impl = impl


def conv2d(
    p: dict,
    x: torch.Tensor,
    *,
    stride: int = 1,
    padding: int = 0,
    lora: Optional[SliderLora] = None,
    name: Optional[str] = None,
) -> torch.Tensor:
    """NHWC conv with an OIHW kernel and symmetric integer padding (+ LoRA
    conv branch: down has the base conv's kernel/stride/padding, up is 1x1).
    Under conv impl 'auto' a routed 3x3 SAME conv runs kernel #5 (a
    bias-less conv passes zeros)."""
    w = p["weight"]
    bias = p.get("bias")
    if (_conv_impl in ("auto", "interpret") and padding == 1
            and conv3x3.routed(x.shape, w.shape, stride)):
        b = (bias.to(x.dtype) if bias is not None
             else torch.zeros(w.shape[0], dtype=x.dtype, device=x.device))
        y = conv3x3.conv3x3(x, w.to(x.dtype), b)
    else:
        y = _nhwc(F.conv2d(
            _nchw(x), w.to(x.dtype), None if bias is None else bias.to(x.dtype),
            stride=stride, padding=padding,
        ))
    return _conv2d_lora_tail(x, y, stride, padding, lora, name)


def _conv2d_lora_tail(x, y, stride, padding, lora, name) -> torch.Tensor:
    entry = _lora_entry(lora, name)
    if entry is None:
        return y
    xc = _nchw(x)
    down, up = entry["down"].to(x.dtype), entry["up"].to(x.dtype)
    rank = entry.get("rank", down.shape[-4])
    scale = _lora_scale(lora.multiplier, entry["alpha"], rank, y)
    if down.ndim == 5:
        # per-row stacked: down (B, r, in, kh, kw), up (B, out, r, 1, 1)
        h = _grouped_per_row_conv(xc, down, stride, padding)
        h = _grouped_per_row_conv(h, up, 1, 0)
    else:
        h = F.conv2d(F.conv2d(xc, down, stride=stride, padding=padding), up)
    return y + _nhwc(h) * scale


def _grouped_per_row_conv(x: torch.Tensor, w: torch.Tensor, stride, padding) -> torch.Tensor:
    """Convolve row b of NCHW `x` (B, C, H, W) with row b's kernel from `w`
    (B, O, C, kh, kw): the rows become the groups of ONE grouped conv."""
    B, C, H, W = x.shape
    O = w.shape[1]
    hg = F.conv2d(
        x.reshape(1, B * C, H, W), w.reshape(B * O, *w.shape[2:]),
        stride=stride, padding=padding, groups=B,
    )
    return hg.reshape(B, O, *hg.shape[2:])


def group_norm(
    p: dict, x: torch.Tensor, num_groups: int = 32, eps: float = 1e-5,
    silu: bool = False,
) -> torch.Tensor:
    """GroupNorm over the channel (last) dim of NHWC with f32 statistics; the
    normalised value is cast to x.dtype before the affine, as in the JAX
    package."""
    B, H, W, C = x.shape
    xg = x.reshape(B, H * W, num_groups, C // num_groups).float()
    var, mean = torch.var_mean(xg, dim=(1, 3), keepdim=True, correction=0)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    out = xg.reshape(B, H, W, C).to(x.dtype)
    out = out * p["weight"].to(x.dtype) + p["bias"].to(x.dtype)
    if silu:
        out = F.silu(out)
    return out


def group_norm_affine(
    p: dict, x: torch.Tensor, num_groups: int = 32, eps: float = 1e-5
) -> tuple[torch.Tensor, torch.Tensor]:
    """GroupNorm folded into per-(batch, channel) f32 vectors (a, s) with
    GN(x) * gamma + beta == x * a + s: a = rstd * gamma, s = beta - mean *
    rstd * gamma (f32 statistics). The normalise + affine + SiLU then runs
    inside kernel #6 (`conv3x3.fused_conv3x3`)."""
    B, H, W, C = x.shape
    gs = C // num_groups
    xg = x.reshape(B, H * W, num_groups, gs).float()
    var, mean = torch.var_mean(xg, dim=(1, 3), correction=0)  # (B, G)
    rstd = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(gs, dim=-1)  # (B, C)
    rstd_c = rstd.repeat_interleave(gs, dim=-1)
    gamma = p["weight"].float()[None]
    beta = p["bias"].float()[None]
    return rstd_c * gamma, beta - mean_c * rstd_c * gamma


@contextlib.contextmanager
def tf32_flags(cudnn: bool, matmul: bool):
    """cuDNN's and cuBLAS's TF32 flags as given inside the block, restored
    after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = cudnn, matmul
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@contextlib.contextmanager
def f16_sums_in_f32():
    """cuBLAS's f16 GEMMs sum in f32 inside the block: PyTorch's default
    (`allow_fp16_reduced_precision_reduction = True`) lets a split-K GEMM
    add its partial sums in f16, where the JAX package and the CPU sum f16
    products in f32. The flag is restored after."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_fp16_reduced_precision_reduction
    matmul.allow_fp16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_fp16_reduced_precision_reduction = saved


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=-1, keepdim=True, correction=0)
    out = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return out * p["weight"].to(x.dtype) + p["bias"].to(x.dtype)


_layout_pin = False


def set_layout_pin(enabled: bool) -> None:
    """Pin the token tensors at the UNet's transformer boundaries with
    kernel #9 (`ops/layout_pin.py`), process-wide, as the JAX package's
    `set_layout_pin` does. Off by default: in the JAX package it lost 15 %
    of the SDXL step on the TPU, and here the boundary tensors are already
    contiguous, so the pin is a pure copy. Takes effect on the next call."""
    global _layout_pin
    _layout_pin = bool(enabled)


def layout_pin(x: torch.Tensor) -> torch.Tensor:
    """`x` copied to a contiguous tensor by kernel #9 (identity gradient,
    also pinned) when the pin is enabled, `x` is a CUDA tensor and 3-D;
    otherwise `x` itself, as the JAX gate returns `x` off the TPU."""
    if not _layout_pin or x.device.type != "cuda" or x.ndim != 3:
        return x
    return LayoutPin.apply(x)


def timestep_embedding(
    t: torch.Tensor,
    dim: int,
    *,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
    scale: float = 1.0,
) -> torch.Tensor:
    """Sinusoidal timestep embedding, diffusers `Timesteps` semantics; f32."""
    half = dim // 2
    exponent = -torch.log(torch.tensor(max_period, dtype=torch.float32)) * torch.arange(
        half, dtype=torch.float32
    )
    exponent = (exponent / (half - downscale_freq_shift)).to(t.device)
    emb = t.float()[:, None] * torch.exp(exponent)[None, :] * scale
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU with the tanh approximation (`jax.nn.gelu(approximate=True)`):
    T5's gated GELU and FLUX's MLPs."""
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "silu": silu,
    "quick_gelu": quick_gelu,
    "gelu": gelu,
}
