"""Compose several trained sliders into one LoRA adapter by concatenating
their ranks (port of sliders_tpu/lora/compose.py).

For each targeted module the k adapters' factors are block-concatenated
along the rank axis, in the port's torch layouts:

    down_cat = [down_1 ; ... ; down_k]              (r_1 + ... + r_k, in)
    up_cat   = [c_1 * up_1 | ... | c_k * up_k]      (out, r_1 + ... + r_k)

with each adapter's effective scale c_i = scale_i * alpha_i / rank_i folded
into its `up` block (conv factors: down (r, in, kh, kw), up (out, r, 1, 1)).
Because the rank index is contracted, up_cat @ down_cat = sum_i c_i * up_i
@ down_i, so one branch serves every slider. The composed entry sets
alpha = total rank, which makes the runtime multiplier a gate: 1 is every
slider at its folded scale, 0 is off; the samplers' start_noise gates the
composition as a whole (generate_images_xl.py:325-328). It runs on the
branch (ops/basic.py) and on the merged path (lora/merge.py):
lora_deltas(composed, 1.0) is the sum of the adapters' deltas.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def compose_sliders(adapters: Sequence[Tuple[dict, float]]) -> dict:
    """Merge [(weights, scale), ...] into one LoRA tree (f32 factors, on the
    first adapter's device for each module).

    `weights` are {module path: {'down', 'up', 'alpha'}} trees as
    lora/network.create_slider_network or lora/io.load_slider give them;
    `scale` is that slider's signed strength. Use the result at multiplier
    (or `slider_scale`) 1. A module that only some adapters target composes
    over that subset."""
    if not adapters:
        raise ValueError("compose_sliders needs at least one (weights, scale)")
    names: dict[str, None] = {}
    for weights, _ in adapters:
        names.update(dict.fromkeys(weights))
    out = {}
    for name in names:
        downs, ups = [], []
        for weights, scale in adapters:
            entry = weights.get(name)
            if entry is None:
                continue
            down, up = entry["down"].float(), entry["up"].float()
            fold = (torch.as_tensor(scale, dtype=torch.float32, device=down.device)
                    * torch.as_tensor(entry["alpha"], dtype=torch.float32, device=down.device)
                    / down.shape[0])
            downs.append(down)
            ups.append(up * fold)
        total_rank = sum(d.shape[0] for d in downs)
        out[name] = {"down": torch.cat(downs, dim=0), "up": torch.cat(ups, dim=1),
                     "alpha": torch.tensor(float(total_rank), device=downs[0].device)}
    return out
