"""Prompt encoding (port of sliders_tpu/pipelines/encoding.py).

  - SD1/2: the last hidden state of CLIP over tokens padded to 77
    (train_util.encode_prompts, train_util.py:60-88);
  - SDXL: the penultimate hidden states of BOTH encoders (before the final
    LayerNorm), concatenated on the feature axis (768 + 1280 = 2048), and
    the pooled projection of encoder 2 (train_util.text_encode_xl /
    encode_prompts_xl, train_util.py:92-133).
"""

from __future__ import annotations

from typing import Optional

import torch

from sliders_tpu_torch.models import clip_text


def _param_device(tree: dict) -> torch.device:
    return tree["text_model"]["embeddings"]["token_embedding"]["weight"].device


def _ids(tokenizer, te_params: dict, prompts: list[str]) -> torch.Tensor:
    return torch.as_tensor(tokenizer(prompts), dtype=torch.long, device=_param_device(te_params))


def encode_prompts(
    tokenizer,
    te_params: dict,
    te_cfg: clip_text.ClipTextConfig,
    prompts: list[str],
    num_layers: Optional[int] = None,
) -> torch.Tensor:
    """(B, 77, D) last hidden state (f32), on the encoder's device."""
    out = clip_text.apply(te_params, _ids(tokenizer, te_params, prompts), te_cfg,
                          num_layers=num_layers)
    return out["last_hidden_state"]


def encode_prompts_xl(tokenizers, te_params_list, te_cfgs,
                      prompts: list[str]) -> tuple[torch.Tensor, torch.Tensor]:
    """(text_embeds (B, 77, D1 + D2), pooled_embeds (B, P)) in f32: each
    encoder's penultimate hidden state, concatenated, and the last encoder's
    projected pooled output (its pooler output if it has no projection)."""
    embeds, pooled = [], None
    for tok, params, cfg in zip(tokenizers, te_params_list, te_cfgs):
        out = clip_text.apply(params, _ids(tok, params, prompts), cfg)
        embeds.append(out["hidden_states"][-2])
        pooled = out.get("text_embeds", out["pooler_output"])
    return torch.cat(embeds, dim=-1), pooled
