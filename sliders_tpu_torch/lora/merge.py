"""Merged-weight LoRA (port of sliders_tpu/lora/merge.py).

For a scalar slider multiplier the low-rank branch equals the base model run
with merged weights

    W' = W + multiplier * (alpha / rank) * (up @ down)

in the port's torch layouts (linear W (out, in), up (out, r), down (r, in);
conv W OIHW, up (out, r, 1, 1), down (r, in, kh, kw)), formed in f32 and cast
to W's dtype, as the JAX package forms it. FLUX slider training runs its
denoise loop and its loss on merged weights (the JAX step,
training/flux_slider.py:106,140-142,172-180), so the port does too: the
merge is differentiable with respect to the LoRA factors, and a bf16 run
rounds where the JAX package's rounds. The per-row (B,) multipliers of
serving keep the branch in `ops/basic.py`.

Under tp (`mesh=`, the weights from `parallel.mesh.shard_params`) a split
weight is this rank's slice, so its delta is sliced the same way from the
whole LoRA: `up[rows] @ down` for an output split, `up @ down[:, cols]`
for an input split (a FLUX single block's `proj_out` in its two parts).
The gradient of a split module's factors is then this rank's share, which
`parallel.collectives.all_reduce_grads` sums over tp.
"""

from __future__ import annotations

from typing import Optional

import torch

from sliders_tpu_torch.parallel.collectives import shard_slice
from sliders_tpu_torch.parallel.mesh import MODEL_AXIS, param_spec
from sliders_tpu_torch.utils import pytree


def _tp_split_of(mesh, name: str) -> Optional[tuple]:
    """(dim of the port's (out, in) layout, index, size, parts) of module
    `name`'s tp split, or None when it runs whole."""
    if mesh is None or name not in mesh.tp_split:
        return None
    dim = 1 if param_spec(f"{name}.weight", True, 2)[0] == MODEL_AXIS else 0
    return dim, mesh.coord(MODEL_AXIS), mesh.size(MODEL_AXIS), mesh.tp_parts.get(name, ())


def _delta(entry: dict, multiplier, split: Optional[tuple] = None) -> torch.Tensor:
    """multiplier * (alpha / rank) * up @ down in f32, shaped like W (like
    this rank's slice of W with `split`, `_tp_split_of`)."""
    down, up = entry["down"].float(), entry["up"].float()
    rank = down.shape[0]
    if split is not None:
        dim, index, size, parts = split
        if dim == 0:
            up = shard_slice(up, 0, index, size, parts=parts)
        else:
            down = shard_slice(down, 1, index, size, parts=parts)
    scale = (torch.as_tensor(multiplier, dtype=torch.float32, device=down.device)
             * entry["alpha"].float() / rank)
    if down.ndim == 2:
        delta = up @ down
    else:  # conv: (out, r) @ (r, in*kh*kw)
        delta = (up[:, :, 0, 0] @ down.flatten(1)).view(up.shape[0], *down.shape[1:])
    return scale * delta


def lora_deltas(lora_weights: dict, multiplier=1.0) -> dict:
    """{module path: full-rank f32 delta}; with `add_deltas`, the merge split
    into a part computed once and an add per use."""
    return {name: _delta(entry, multiplier) for name, entry in lora_weights.items()}


def add_deltas(params: dict, deltas: dict, gate=1.0) -> dict:
    """`params` with `gate * delta` added to each targeted weight (in f32,
    cast back to the weight's dtype); other leaves are passed through."""
    flat = pytree.flatten(params)
    out = dict(flat)
    for name, delta in deltas.items():
        key = f"{name}.weight"
        base = flat[key]
        out[key] = (base.float() + gate * delta).to(base.dtype)
    return pytree.unflatten(out)


def merge_lora_weights(params: dict, lora_weights: dict, multiplier, mesh=None) -> dict:
    """A parameter tree with the LoRA deltas folded into the targeted
    weights (each split module's delta sliced like its weight under
    `mesh`'s tp split); untargeted leaves are the same tensors (no
    copies)."""
    flat = pytree.flatten(params)
    out = dict(flat)
    for name, entry in lora_weights.items():
        key = f"{name}.weight"
        base = flat[key]
        out[key] = (base.float() + _delta(entry, multiplier, _tp_split_of(mesh, name))
                    ).to(base.dtype)
    return pytree.unflatten(out)
