"""Slider checkpoint I/O, interoperable with reference-trained sliders
(port of sliders_tpu/lora/io.py).

Key convention (lora.py:28,206-207,94):
  lora_unet_<module path, dots -> underscores>.lora_down.weight  (torch layout)
  lora_unet_<...>.lora_up.weight
  lora_unet_<...>.alpha
The port keeps torch layouts, so the factors load as stored. Because the
underscore flattening is lossy, names resolve against the candidate module
paths of the given UNet parameter dict. Both `.safetensors` (written by
`models/convert.write_safetensors`, no package needed) and torch `.pt` files
are written and read, so the JAX package and the reference load what the
port saves and the other way round.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from sliders_tpu_torch.lora.network import target_module_paths
from sliders_tpu_torch.models.convert import read_safetensors, write_safetensors

LORA_PREFIX_UNET = "lora_unet"


def _flat_name(module_path: str) -> str:
    return f"{LORA_PREFIX_UNET}_{module_path.replace('.', '_')}"


def torch_precision(precision: str) -> torch.dtype:
    """Save-precision string -> torch dtype (`numpy_precision` of the JAX
    package)."""
    if precision in ("fp16", "float16"):
        return torch.float16
    if precision in ("bf16", "bfloat16"):
        return torch.bfloat16
    return torch.float32


def to_reference_state_dict(weights: dict, dtype=torch.float32) -> dict:
    """LoRA tree -> reference-layout flat state dict (contiguous CPU tensors
    in `dtype`; the port's factors already have the torch layouts)."""
    out = {}
    for module, w in weights.items():
        name = _flat_name(module)
        out[f"{name}.lora_down.weight"] = w["down"].detach().to("cpu", dtype).contiguous()
        out[f"{name}.lora_up.weight"] = w["up"].detach().to("cpu", dtype).contiguous()
        out[f"{name}.alpha"] = torch.as_tensor(w["alpha"]).detach().to("cpu", dtype).reshape(())
    return out


def save_slider(path: str, weights: dict, dtype=torch.float32, metadata: Optional[dict] = None):
    """Write a slider checkpoint; the format follows the extension
    (.safetensors, else a torch .pt state dict), as the reference's
    LoRANetwork.save_weights does (lora.py:245-248)."""
    state = to_reference_state_dict(weights, dtype)
    if os.path.splitext(path)[1] == ".safetensors":
        write_safetensors(path, state, {k: str(v) for k, v in (metadata or {}).items()})
    else:
        torch.save(state, path)


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
