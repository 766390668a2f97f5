"""Prompt-pair objective layer (port of sliders_tpu/prompts/settings.py).

The four prompts of one slider (target / positive / unconditional / neutral)
with the reference's defaulting (prompt_util.py:56-68), the erase/enhance
objective (prompt_util.py:108-148), and the disentanglement-attribute
Cartesian expansion (prompt_util.py:151-174). Prompt files are read with
`core/yaml_subset.py`; entries are built with the config's pydantic-lax
coercion (`core/config.build`), unknown keys (such as the GPT-helper files'
`rank:`) ignored.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import List, Literal, Optional

import torch

from sliders_tpu_torch.core import yaml_subset
from sliders_tpu_torch.core.config import build, to_dict

ACTION_TYPES = Literal["erase", "enhance"]


@dataclass
class PromptSettings:
    """One slider definition (YAML entry)."""

    target: str
    positive: Optional[str] = None  # defaults to target
    unconditional: str = ""
    neutral: Optional[str] = None  # defaults to unconditional
    action: ACTION_TYPES = "erase"
    guidance_scale: float = 1.0
    resolution: int = 512
    dynamic_resolution: bool = False
    batch_size: int = 1
    dynamic_crops: bool = False  # only used for XL

    @classmethod
    def from_dict(cls, values: dict) -> "PromptSettings":
        """The JAX package's `fill_prompts` defaulting, then coercion."""
        if not isinstance(values, dict):
            raise ValueError(f"PromptSettings: input should be a mapping, got {values!r}")
        values = dict(values)
        if "target" not in values:
            raise ValueError("target must be specified")
        if values.get("positive") is None:
            values["positive"] = values["target"]
        values.setdefault("unconditional", "")
        if values.get("neutral") is None:
            values["neutral"] = values["unconditional"]
        # the GPT-helper YAMLs write 'guidance' instead of 'guidance_scale'
        if "guidance_scale" not in values and "guidance" in values:
            values["guidance_scale"] = values["guidance"]
        return build(cls, values)

    def to_dict(self) -> dict:
        return to_dict(self)


def load_prompts_from_yaml(path, attributes: List[str] = ()) -> list[PromptSettings]:
    """Load slider prompt definitions; with disentanglement attributes, each
    entry becomes one copy per attribute with the attribute prepended to all
    four prompts (prompt_util.py:157-166), after defaulting."""
    prompts = yaml_subset.load(path)
    if not prompts:
        raise ValueError("prompts file is empty")
    if not isinstance(prompts, list):
        raise ValueError(f"{path}: a prompts file is a list of entries")
    if attributes:
        expanded = []
        for entry in prompts:
            filled = PromptSettings.from_dict(entry).to_dict()
            for att in attributes:
                c = copy.deepcopy(filled)
                for k in ("target", "positive", "neutral", "unconditional"):
                    c[k] = f"{att} {c[k]}"
                expanded.append(c)
    else:
        expanded = copy.deepcopy(prompts)
    return [PromptSettings.from_dict(p) for p in expanded]


def slider_target(action: str, positive: torch.Tensor, unconditional: torch.Tensor,
                  neutral: torch.Tensor, guidance_scale: float) -> torch.Tensor:
    """The eps-space regression target of the slider objective:
    erase   -> neutral - g * (positive - unconditional)   (prompt_util.py:108-120)
    enhance -> neutral + g * (positive - unconditional)   (prompt_util.py:123-135)
    """
    direction = guidance_scale * (positive - unconditional)
    if action == "erase":
        return neutral - direction
    if action == "enhance":
        return neutral + direction
    raise ValueError("action must be erase or enhance")


def slider_loss(action: str, target_pred: torch.Tensor, positive: torch.Tensor,
                unconditional: torch.Tensor, neutral: torch.Tensor,
                guidance_scale: float) -> torch.Tensor:
    """MSE (f32) between the LoRA-on target prediction and the slider target."""
    goal = slider_target(action, positive, unconditional, neutral, guidance_scale)
    diff = target_pred.float() - goal.float()
    return torch.mean(diff * diff)
