"""Slider LoRA network: targeting rules and initialisation
(port of sliders_tpu/lora/network.py).

Instead of monkey-patching module forwards as the reference does
(trainscripts/textsliders/lora.py:115-218), the target Linear/Conv call
sites of the UNet parameter dict are enumerated by dotted module path and a
separate LoRA tree is built under those names; `ops/basic.py` adds the
low-rank branch at matching call sites. Targeting reproduces the reference:
'lierla' takes to_q/to_k/to_v/to_out.0 of every attn1/attn2, 'c3lier' adds
the ResnetBlock2D and sampler convs, and `train_method` filters on the
parent and child names (lora.py:176-205). `trainable_mask` freezes the
alphas. Factors are torch layouts: linear down (r, in), up (out, r); conv
down (r, in, kh, kw), up (out, r, 1, 1).
"""

from __future__ import annotations

import math
import re
from typing import Optional

import torch

from sliders_tpu_torch.utils import pytree

_ATTN_PARENT = re.compile(r"^(.*\battn[12])\.(to_q|to_k|to_v|to_out\.0)\.weight$")
_RESNET_PARENT = re.compile(
    r"^(.*\bresnets\.\d+)\.(conv1|conv2|time_emb_proj|conv_shortcut)\.weight$"
)
_DOWNSAMPLER = re.compile(r"^(.*\bdownsamplers\.0)\.(conv)\.weight$")
_UPSAMPLER = re.compile(r"^(.*\bupsamplers\.0)\.(conv)\.weight$")

CONV_PATTERNS = (_RESNET_PARENT, _DOWNSAMPLER, _UPSAMPLER)


def _method_allows(parent: str, child: str, train_method: str) -> bool:
    """Name filters of the reference create_modules (lora.py:176-205)."""
    if train_method in ("noxattn", "noxattn-hspace", "noxattn-hspace-last"):
        if "attn2" in parent or "time_embed" in parent:
            return False
    elif train_method == "innoxattn":
        if "attn2" in parent:
            return False
    elif train_method == "selfattn":
        if "attn1" not in parent:
            return False
    elif train_method in ("xattn", "xattn-strict"):
        if "attn2" not in parent:
            return False
    elif train_method in ("xattn-up", "xattn-down", "xattn-mid"):
        pos = {"xattn-up": "up_block", "xattn-down": "down_block", "xattn-mid": "mid_block"}
        if "attn" not in parent or pos[train_method] not in parent:
            return False
    elif train_method == "full":
        pass
    else:
        raise NotImplementedError(f"train_method: {train_method} is not implemented.")

    if train_method == "xattn-strict" and "out" in child:
        return False
    if train_method == "noxattn-hspace" and "mid_block" not in parent:
        return False
    if train_method == "noxattn-hspace-last":
        if "mid_block" not in parent or ".1" not in parent or "conv2" not in child:
            return False
    return True


def target_module_paths(
    unet_params: dict, network_type: str = "lierla", train_method: str = "full"
) -> list[str]:
    """Dotted module paths (call-site names) that receive LoRA, sorted."""
    patterns = [_ATTN_PARENT]
    if network_type == "c3lier":
        patterns += list(CONV_PATTERNS)
    elif network_type != "lierla":
        raise ValueError(f"unknown network type {network_type}")
    out = set()
    for path in pytree.flatten(unet_params):
        for pat in patterns:
            m = pat.match(path)
            if m is not None and _method_allows(m.group(1), m.group(2), train_method):
                out.add(f"{m.group(1)}.{m.group(2)}")
    return sorted(out)


def _kaiming_uniform(generator, shape, fan_in: int, a: float, dtype, device) -> torch.Tensor:
    bound = math.sqrt(6.0 / ((1.0 + a * a) * fan_in))
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
    return ((u * 2.0 - 1.0) * bound).to(dtype)


def create_slider_network(
    generator: Optional[torch.Generator],
    unet_params: dict,
    rank: int = 4,
    alpha: float = 1.0,
    train_method: str = "full",
    network_type: str = "lierla",
    init_a: float = 1.0,
    dtype=torch.float32,
    device="cpu",
) -> dict:
    """Build the LoRA tree {module_path: {'down', 'up', 'alpha'}}: down is
    kaiming-uniform with slope `init_a` (1 for the text sliders, lora.py:97;
    sqrt(5) for the image sliders' copy), up is zero, and alpha defaults to
    the rank when 0/None. Conv ranks clamp to min(rank, in, out)."""
    modules = target_module_paths(unet_params, network_type, train_method)
    flat = pytree.flatten(unet_params)
    weights: dict[str, dict] = {}
    for module in modules:
        w = flat[f"{module}.weight"]
        if w.ndim == 2:  # linear (out, in)
            d_out, d_in = w.shape
            r = rank
            down = _kaiming_uniform(generator, (r, d_in), d_in, init_a, dtype, device)
            up = torch.zeros((d_out, r), dtype=dtype, device=device)
        else:  # conv OIHW
            d_out, d_in, kh, kw = w.shape
            r = min(rank, d_in, d_out)  # lora.py:78-80 clamp
            down = _kaiming_uniform(generator, (r, d_in, kh, kw), d_in * kh * kw, init_a,
                                    dtype, device)
            up = torch.zeros((d_out, r, 1, 1), dtype=dtype, device=device)
        a = float(alpha) if alpha not in (None, 0) else float(r)
        weights[module] = {"down": down, "up": up,
                           "alpha": torch.tensor(a, dtype=dtype, device=device)}
    if not weights:
        raise ValueError(f"no LoRA targets for type={network_type} method={train_method}")
    return weights


def trainable_mask(weights: dict) -> dict:
    """True for the trainable factors (down/up), False for alpha, a constant
    buffer in the reference (lora.py:94)."""
    return {m: {"down": True, "up": True, "alpha": False} for m in weights}


def param_count(weights: dict) -> int:
    return sum(w[k].numel() for w in weights.values() for k in ("down", "up"))
