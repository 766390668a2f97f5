"""One-pass GroupNorm (+ SiLU) over (B, L, C): the hand-written Hopper
kernel #8 and its plain version (counterpart of
sliders_tpu/ops/pallas_groupnorm.py).

`fused_group_norm(x, gamma, beta, num_groups, eps, act_silu)` launches the
kernel in `csrc/group_norm.cu` on a CUDA tensor, or raises; on a CPU tensor
it runs `fused_group_norm_ref`, the TPU kernel's formula
(`pallas_groupnorm.py:43-78`): f32 sums and sums of squares per group,
var = E[x^2] - mean^2, the per-channel scale a = rsqrt(var + eps) * gamma
and shift b = beta - mean * rsqrt * gamma folded in f32 and rounded to the
input dtype, y = x * a + b in the input dtype, and the SiLU's sigmoid taken
in f32 and rounded before its product.

Like the JAX package (`ops/basic.py:234-237`), the port routes this kernel
nowhere: `ops/basic.group_norm` stays the UNet's path (its statistics are
two-pass f32 and it rounds at other points), and `chip_smoke.py` holds the
kernel against its plain version. It has no gradient: the JAX package's
backward recomputes `basic.group_norm`, which is reachable directly.
"""

from __future__ import annotations

import torch

from sliders_tpu_torch.ops import _build

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def fused_group_norm_ref(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         num_groups: int = 32, eps: float = 1e-5,
                         act_silu: bool = False) -> torch.Tensor:
    """Plain version of kernel #8 (see the module docstring)."""
    B, L, C = x.shape
    cg = C // num_groups
    xg = x.reshape(B, L, num_groups, cg).float()
    n = L * cg
    mean = xg.sum(dim=(1, 3)) / n  # (B, G)
    var = (xg * xg).sum(dim=(1, 3)) / n - mean * mean
    inv = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(cg, dim=-1)[:, None, :]
    inv_c = inv.repeat_interleave(cg, dim=-1)[:, None, :]
    g, b = gamma.float(), beta.float()
    a = (inv_c * g).to(x.dtype)
    shift = (b - mean_c * inv_c * g).to(x.dtype)
    y = x * a + shift
    if act_silu:
        y = y * torch.sigmoid(y.float()).to(x.dtype)
    return y


def fused_group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     num_groups: int = 32, eps: float = 1e-5,
                     act_silu: bool = False) -> torch.Tensor:
    """GroupNorm (+ SiLU) of (B, L, C) x with (C,) gamma and beta; the
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if x.ndim != 3 or x.shape[2] % num_groups or tuple(gamma.shape) != (x.shape[2],) or (
            tuple(beta.shape) != (x.shape[2],)):
        raise ValueError(f"takes (B, L, C) x with C a multiple of {num_groups} and (C,) "
                         f"gamma/beta, got {tuple(x.shape)}, {tuple(gamma.shape)}, "
                         f"{tuple(beta.shape)}")
    if x.device.type == "cpu":
        return fused_group_norm_ref(x, gamma, beta, num_groups, eps, act_silu)
    if x.device.type != "cuda":
        raise ValueError(f"fused_group_norm runs on cpu or cuda, not {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused_group_norm takes bf16 or f32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"fused_group_norm needs a contiguous (B, L, C) x, got strides "
                         f"{x.stride()}")
    if gamma.device != x.device or beta.device != x.device:
        raise ValueError("gamma and beta must be on x's device")
    if gamma.stride(0) != 1 or beta.stride(0) != 1:
        raise ValueError(f"fused_group_norm needs contiguous gamma and beta, got strides "
                         f"{gamma.stride()} and {beta.stride()}")
    B, L, C = x.shape
    g = gamma.float()  # (C,) parameters, read in f32 as the TPU kernel does
    b = beta.float()
    y = torch.empty_like(x)
    lib = _build.library("group_norm")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.group_norm_launch(x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
                                   B, L, C, num_groups, _DTYPES[x.dtype], int(act_silu),
                                   float(eps), stream)
    if rc != 0:
        raise RuntimeError(f"fused_group_norm kernel launch failed: CUDA error {rc}")
    fused_group_norm.launches += 1
    return y


# kernel launches since the last reset (CPU calls are not counted)
fused_group_norm.launches = 0
