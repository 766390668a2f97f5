"""Debug helpers over the port's trees (port of sliders_tpu/utils/debug.py):
a slider network summary, a NaN / Inf scan and a parameter count, giving
the JAX functions' strings and paths on the same tree.

The reference's debug_util.py prints the first modules' requires_grad and
training flags (debug_util.py:6-16); here 'trainable' is the LoRA tree the
step differentiates, so the summary reports shapes, ranks and sizes.
"""

from __future__ import annotations

import math

import torch

from sliders_tpu_torch.utils import pytree


def _rank(down: torch.Tensor) -> int:
    """A `down` factor's rank: (r, in) / (r, in, kh, kw) solo, with a
    leading row axis when per-row stacked."""
    return down.shape[1] if down.ndim in (3, 5) else down.shape[0]


def describe_network(lora_weights: dict, max_modules: int = 5) -> str:
    """Summary of the slider network: the first `max_modules` modules (by
    name) with rank, alpha and size, then the module and parameter totals."""
    lines = []
    total = 0
    for i, (name, w) in enumerate(sorted(lora_weights.items())):
        n = math.prod(w["down"].shape) + math.prod(w["up"].shape)
        total += n
        if i < max_modules:
            lines.append(
                f"  {name}: rank={_rank(w['down'])} alpha={float(w['alpha']):g} params={n}"
            )
    lines.append(f"  ... {len(lora_weights)} modules, {total:,} trainable params")
    return "\n".join(lines)


def find_nonfinite(tree: dict) -> list[str]:
    """Paths of floating leaves holding a NaN or an Inf (syncs the device;
    debug only)."""
    return [path for path, leaf in pytree.flatten(tree).items()
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
            and not bool(torch.isfinite(leaf).all())]


def param_count(tree: dict) -> int:
    return sum(math.prod(leaf.shape) for leaf in pytree.flatten(tree).values())
