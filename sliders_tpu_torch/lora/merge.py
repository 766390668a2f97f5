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
"""

from __future__ import annotations

import torch

from sliders_tpu_torch.utils import pytree


def _delta(entry: dict, multiplier) -> torch.Tensor:
    """multiplier * (alpha / rank) * up @ down in f32, shaped like W."""
    down, up = entry["down"].float(), entry["up"].float()
    rank = down.shape[0]
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


def merge_lora_weights(params: dict, lora_weights: dict, multiplier) -> dict:
    """A parameter tree with the LoRA deltas folded into the targeted
    weights; untargeted leaves are the same tensors (no copies)."""
    flat = pytree.flatten(params)
    out = dict(flat)
    for name, entry in lora_weights.items():
        key = f"{name}.weight"
        base = flat[key]
        out[key] = (base.float() + _delta(entry, multiplier)).to(base.dtype)
    return pytree.unflatten(out)
