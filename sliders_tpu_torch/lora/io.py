"""Slider checkpoint loading, interoperable with reference-trained sliders
(port of the load side of sliders_tpu/lora/io.py).

Key convention (lora.py:28,206-207,94):
  lora_unet_<module path, dots -> underscores>.lora_down.weight  (torch layout)
  lora_unet_<...>.lora_up.weight
  lora_unet_<...>.alpha
The port keeps torch layouts, so the factors load as stored. Because the
underscore flattening is lossy, names resolve against the candidate module
paths of the given UNet parameter dict. Saving comes with training
(ROADMAP queue 1, item 3).
"""

from __future__ import annotations

import os

import torch

from sliders_tpu_torch.lora.network import target_module_paths
from sliders_tpu_torch.models.convert import read_safetensors

LORA_PREFIX_UNET = "lora_unet"


def _flat_name(module_path: str) -> str:
    return f"{LORA_PREFIX_UNET}_{module_path.replace('.', '_')}"


def from_reference_state_dict(state: dict, unet_params: dict) -> dict:
    """Reference-layout flat state dict -> LoRA tree (f32, on the CPU)."""
    candidates = {_flat_name(p): p for p in target_module_paths(unet_params, "c3lier", "full")}
    weights: dict[str, dict] = {}
    for key in state:
        if not key.endswith(".lora_down.weight"):
            continue
        name = key[: -len(".lora_down.weight")]
        if name not in candidates:
            raise KeyError(f"cannot resolve LoRA module {name!r} against the UNet")
        down = torch.as_tensor(state[f"{name}.lora_down.weight"]).float()
        up = torch.as_tensor(state[f"{name}.lora_up.weight"]).float()
        alpha = state.get(f"{name}.alpha")
        a = float(torch.as_tensor(alpha)) if alpha is not None else float(down.shape[0])
        weights[candidates[name]] = {
            "down": down.contiguous(),
            "up": up.contiguous(),
            "alpha": torch.tensor(a, dtype=torch.float32),
        }
    if not weights:
        raise ValueError("no lora_down weights found in state dict")
    return weights


def load_slider(path: str, unet_params: dict) -> dict:
    """Read a slider checkpoint (.safetensors, or a torch .pt state dict as
    the reference saves it)."""
    if os.path.splitext(path)[1] == ".safetensors":
        state = read_safetensors(path)
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
    return from_reference_state_dict(state, unet_params)
