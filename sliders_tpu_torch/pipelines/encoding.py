"""Prompt encoding (port of the SD1/2 path of sliders_tpu/pipelines/encoding.py):
the last hidden state of CLIP over tokens padded to 77
(train_util.encode_prompts, train_util.py:60-88). The SDXL dual-encoder
path comes with ROADMAP queue 1, item 6."""

from __future__ import annotations

from typing import Optional

import torch

from sliders_tpu_torch.models import clip_text


def _param_device(tree: dict) -> torch.device:
    return tree["text_model"]["embeddings"]["token_embedding"]["weight"].device


def encode_prompts(
    tokenizer,
    te_params: dict,
    te_cfg: clip_text.ClipTextConfig,
    prompts: list[str],
    num_layers: Optional[int] = None,
) -> torch.Tensor:
    """(B, 77, D) last hidden state (f32), on the encoder's device."""
    ids = torch.as_tensor(tokenizer(prompts), dtype=torch.long, device=_param_device(te_params))
    out = clip_text.apply(te_params, ids, te_cfg, num_layers=num_layers)
    return out["last_hidden_state"]
