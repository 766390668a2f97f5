"""The layout pin, kernel #9: a contiguous copy of a (B, L, C) tensor
(counterpart of sliders_tpu/ops/basic.py:326-385).

The JAX package pins the token tensors at the UNet's transformer boundaries
to the row-major layout with a Pallas identity, so that XLA cannot carry a
conv's L-minor layout into the LayerNorms; its `custom_vjp` pins the
cotangent with the same copy. The port keeps the copy and its gradient:

  - `layout_pin_copy(x)` launches the kernel in `csrc/layout_pin.cu` on a
    CUDA tensor (any strides; the output is a fresh contiguous tensor with
    the input's bits) or raises; on a CPU tensor it runs `layout_pin_ref`;
  - `LayoutPin` is the autograd Function whose backward runs the same copy
    on the cotangent and saves nothing.

`ops/basic.layout_pin` is the gate the UNet calls (off by default, as in
the JAX package).
"""

from __future__ import annotations

import torch

from sliders_tpu_torch.ops import _build

_ELEM_BYTES = {torch.bfloat16: 2, torch.float32: 4}


def layout_pin_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel #9: `x` copied into a fresh contiguous tensor."""
    return x.clone(memory_format=torch.contiguous_format)


def layout_pin_copy(x: torch.Tensor) -> torch.Tensor:
    """Contiguous copy of (B, L, C) `x`, bit for bit: the kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if x.ndim != 3:
        raise ValueError(f"layout_pin_copy takes a (B, L, C) tensor, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return layout_pin_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"layout_pin_copy runs on cpu or cuda, not {x.device}")
    if x.dtype not in _ELEM_BYTES:
        raise ValueError(f"layout_pin_copy takes bf16 or f32, got {x.dtype}")
    B, L, C = x.shape
    y = torch.empty((B, L, C), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _build.library("layout_pin")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.layout_pin_launch(x.data_ptr(), y.data_ptr(), B, L, C, *x.stride(),
                                   _ELEM_BYTES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"layout_pin kernel launch failed: CUDA error {rc} for shape "
                           f"{tuple(x.shape)} strides {x.stride()}")
    layout_pin_copy.launches += 1
    return y


# kernel launches since the last reset (CPU calls are not counted)
layout_pin_copy.launches = 0


class LayoutPin(torch.autograd.Function):
    """Identity with the copy on both sides: the forward pins x, the backward
    pins the cotangent (`_layout_pin_bwd`, sliders_tpu/ops/basic.py:361-364).
    Nothing is saved for the backward."""

    @staticmethod
    def forward(ctx, x):
        return layout_pin_copy(x)

    @staticmethod
    def backward(ctx, g):
        return layout_pin_copy(g)
