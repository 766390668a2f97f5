"""Per-row stacked LoRA adapters: serve DIFFERENT sliders in ONE batch
(port of sliders_tpu/lora/batch.py).

`stack_sliders` stacks adapter trees with the same module set leaf-wise, so
every leaf gains a leading ROW axis: down (B, r, in), up (B, out, r),
alpha (B,). Adapters of different ranks are zero-padded along the rank axis
to the batch max (padded rank columns are exact no-ops in up(down(x))), and
a per-row `rank` leaf keeps each row's TRUE rank, so the alpha/rank scale
stays each row's solo value. `ops/basic.py` sees the extra axis and applies
the branch per row with one batched product (one grouped conv for convs).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def _rank_axes(entry: dict) -> tuple[int, int]:
    """(down rank axis, up rank axis) of a solo or stacked entry: down keeps
    rank first ((r, in) / (r, in, kh, kw)), up second ((out, r) /
    (out, r, 1, 1)); a stacked entry shifts both by its row axis."""
    stacked = int(entry["alpha"].ndim > 0)
    return stacked, 1 + stacked


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def structure_signature(weights: dict) -> tuple:
    """Hashable signature: module names + factor shapes WITHOUT the rank axis
    + dtypes. Two adapters batch together iff their signatures are equal."""
    if not weights:
        raise ValueError(
            "empty adapter tree has no structure signature (the train "
            "method matched no modules on this architecture?)"
        )
    sig = []
    for name in sorted(weights):
        entry = weights[name]
        d_ax, u_ax = _rank_axes(entry)
        down_shape = list(entry["down"].shape)
        up_shape = list(entry["up"].shape)
        del down_shape[d_ax], up_shape[u_ax]
        sig.append((name, tuple(down_shape), _dtype_name(entry["down"].dtype),
                    tuple(up_shape), _dtype_name(entry["up"].dtype)))
    return tuple(sig)


def _pad_rank(x: torch.Tensor, axis: int, to: int) -> torch.Tensor:
    if x.shape[axis] == to:
        return x
    pad = [0, 0] * x.ndim  # F.pad lists dims last-first
    pad[2 * (x.ndim - 1 - axis) + 1] = to - x.shape[axis]
    return F.pad(x, pad)


def stack_sliders(weight_trees: Sequence[dict], *, round_ranks_pow2: bool = False) -> dict:
    """Stack B same-module-set solo adapter trees into one per-row tree
    (`weight_trees[b]` is row b's adapter; repeats allowed). Mixed ranks are
    zero-padded to the per-module max, rounded up to a power of two with
    `round_ranks_pow2`. Raises ValueError on a structure mismatch."""
    if not weight_trees:
        raise ValueError("stack_sliders needs at least one adapter")
    sig0 = structure_signature(weight_trees[0])
    for w in weight_trees[1:]:
        if structure_signature(w) != sig0:
            raise ValueError(
                "cannot stack sliders with different structures "
                "(module sets / base dims / dtypes differ)"
            )
    out = {}
    for name in weight_trees[0]:
        entries = [w[name] for w in weight_trees]
        d_ax, u_ax = _rank_axes(entries[0])
        ranks = [e["down"].shape[d_ax] for e in entries]
        r_max = max(ranks)
        if round_ranks_pow2:
            r_max = 1 << (r_max - 1).bit_length()
        out[name] = {
            "down": torch.stack([_pad_rank(e["down"], d_ax, r_max) for e in entries]),
            "up": torch.stack([_pad_rank(e["up"], u_ax, r_max) for e in entries]),
            "alpha": torch.stack([e["alpha"].to(torch.float32) for e in entries]),
            # true per-row ranks: ops/basic._lora_scale divides by these
            "rank": torch.tensor(ranks, dtype=torch.float32, device=entries[0]["down"].device),
        }
    return out


def is_stacked(weights: dict) -> bool:
    """True for a per-row stacked tree (alpha carries the row axis)."""
    if not weights:
        return False
    return next(iter(weights.values()))["alpha"].ndim > 0
