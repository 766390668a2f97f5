"""Parameter-tree helpers shared by the models: random init with the JAX
package's distributions, and moving a tree to a device/dtype."""

from __future__ import annotations

from typing import Optional

import torch


class ParamFactory:
    """Draws parameters with the JAX package's init distributions (normal
    weights scaled by fan_in^-1/2, zero biases, unit norm scales) from an
    explicit torch.Generator, in torch layouts. On the "meta" device it
    only allocates shapes (structure checks without the memory)."""

    def __init__(self, generator: Optional[torch.Generator], dtype, device):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device)

    def normal(self, shape, std: float) -> torch.Tensor:
        if self.device.type == "meta":
            return torch.empty(shape, dtype=self.dtype, device=self.device)
        # drawn in the target dtype on the target device: no f32 copy of a
        # bf16 model is ever held (FLUX-dev's would be 48 GB)
        w = torch.randn(shape, generator=self.generator, dtype=self.dtype, device=self.device)
        return w.mul_(std)

    def const(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, dtype=self.dtype, device=self.device)

    def dense(self, i: int, o: int, bias: bool = True, std: Optional[float] = None) -> dict:
        p = {"weight": self.normal((o, i), i**-0.5 if std is None else std)}
        if bias:
            p["bias"] = self.const((o,), 0.0)
        return p

    def conv(self, i: int, o: int, k: int = 3) -> dict:
        """OIHW weight laid out channels_last, as `tree_to` lays it out: the
        one layout of the port's conv weights (the conv kernels take no
        other)."""
        w = self.normal((o, i, k, k), (i * k * k) ** -0.5)
        return {
            "weight": w.contiguous(memory_format=torch.channels_last),
            "bias": self.const((o,), 0.0),
        }

    def norm(self, c: int) -> dict:
        return {"weight": self.const((c,), 1.0), "bias": self.const((c,), 0.0)}


def tree_to(tree: dict, device=None, dtype=None) -> dict:
    """Move every tensor leaf of a nested dict to `device`; floating leaves
    are also cast to `dtype` (when given) and 4-D conv weights are laid out
    channels_last, the layout the convs run in."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = tree_to(v, device, dtype)
            continue
        to_dtype = dtype if dtype is not None and v.is_floating_point() else v.dtype
        fmt = torch.channels_last if v.ndim == 4 else torch.preserve_format
        out[k] = v.to(device=device, dtype=to_dtype, memory_format=fmt)
    return out
