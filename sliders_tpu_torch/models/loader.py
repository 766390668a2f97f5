"""Model loading from LOCAL diffusers snapshot directories
(port of the SD1 path of sliders_tpu/models/loader.py).

A snapshot holds unet/ text_encoder/ tokenizer/ vae/ subfolders with
config.json and safetensors weights. Single-file LDM checkpoints, SDXL and
FLUX snapshots come with later items of ROADMAP queue 1 (items 6, 11, 16).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch

from sliders_tpu_torch.models import clip_text, convert, unet2d, vae
from sliders_tpu_torch.models.params import tree_to
from sliders_tpu_torch.text.tokenizer import ClipTokenizer


def unet_config_from_hf(cfg: dict) -> unet2d.UNetConfig:
    heads = cfg.get("num_attention_heads") or cfg["attention_head_dim"]
    n_blocks = len(cfg["block_out_channels"])
    if isinstance(heads, int):
        heads = (heads,) * n_blocks
    tl = cfg.get("transformer_layers_per_block", 1)
    if isinstance(tl, int):
        tl = (tl,) * n_blocks
    return unet2d.UNetConfig(
        in_channels=cfg.get("in_channels", 4),
        out_channels=cfg.get("out_channels", 4),
        block_out_channels=tuple(cfg["block_out_channels"]),
        down_block_types=tuple(cfg["down_block_types"]),
        up_block_types=tuple(cfg["up_block_types"]),
        layers_per_block=cfg.get("layers_per_block", 2),
        cross_attention_dim=cfg.get("cross_attention_dim", 768),
        num_attention_heads=tuple(heads),
        transformer_layers_per_block=tuple(tl),
        use_linear_projection=cfg.get("use_linear_projection", False),
        norm_num_groups=cfg.get("norm_num_groups", 32),
        addition_embed_type=cfg.get("addition_embed_type"),
        addition_time_embed_dim=cfg.get("addition_time_embed_dim", 256),
        projection_class_embeddings_input_dim=cfg.get("projection_class_embeddings_input_dim"),
    )


def clip_config_from_hf(cfg: dict) -> clip_text.ClipTextConfig:
    eos = cfg.get("eos_token_id", 2)
    if eos == 2 and cfg.get("vocab_size", 49408) == 49408:
        # legacy HF configs say eos=2 and rely on argmax pooling; the real
        # CLIP EOS/pad id is 49407
        eos = 49407
    return clip_text.ClipTextConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        max_positions=cfg.get("max_position_embeddings", 77),
        hidden_act=cfg.get("hidden_act", "quick_gelu"),
        eos_token_id=eos,
        projection_dim=cfg.get("projection_dim"),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-5),
    )


def vae_config_from_hf(cfg: dict) -> vae.VaeConfig:
    return vae.VaeConfig(
        in_channels=cfg.get("in_channels", 3),
        out_channels=cfg.get("out_channels", 3),
        latent_channels=cfg.get("latent_channels", 4),
        block_out_channels=tuple(cfg["block_out_channels"]),
        layers_per_block=cfg.get("layers_per_block", 2),
        norm_num_groups=cfg.get("norm_num_groups", 32),
        scaling_factor=cfg.get("scaling_factor", 0.18215),
        shift_factor=cfg.get("shift_factor") or 0.0,
    )


@dataclass
class TextEncoderBundle:
    tokenizer: ClipTokenizer
    params: dict
    config: clip_text.ClipTextConfig
    clip_skip_layers: Optional[int] = None  # override for apply(num_layers=...)


@dataclass
class SDModels:
    unet_params: dict
    unet_config: unet2d.UNetConfig
    text_encoders: list  # one CLIP for SD1
    vae_params: Optional[dict] = None
    vae_config: Optional[vae.VaeConfig] = None
    is_xl: bool = False


def load_sd(
    model_dir: str,
    *,
    device="cpu",
    v2: bool = False,
    clip_skip: Optional[int] = None,
    dtype=torch.bfloat16,
    load_vae: bool = False,
) -> SDModels:
    """SD1.x / SD2.x diffusers snapshot -> SDModels with every parameter on
    `device` in `dtype`. clip_skip k keeps num_layers - (k - 1) text layers
    (v2 defaults to clip_skip 2, as the reference does)."""
    if model_dir.endswith((".ckpt", ".safetensors")):
        raise NotImplementedError(
            "single-file LDM checkpoints are not ported yet (ROADMAP queue 1, item 16)"
        )
    if clip_skip is None and v2:
        clip_skip = 2
    unet_cfg = unet_config_from_hf(convert.load_component_config(model_dir, "unet"))
    unet_params = tree_to(convert.load_component(model_dir, "unet"), device, dtype)

    te_cfg = clip_config_from_hf(convert.load_component_config(model_dir, "text_encoder"))
    te_params = tree_to(convert.load_component(model_dir, "text_encoder"), device, dtype)
    tokenizer = ClipTokenizer.from_pretrained(os.path.join(model_dir, "tokenizer"))
    tokenizer.model_max_length = te_cfg.max_positions
    layers = te_cfg.num_layers - (clip_skip - 1) if clip_skip is not None else None
    bundle = SDModels(
        unet_params, unet_cfg, [TextEncoderBundle(tokenizer, te_params, te_cfg, layers)]
    )
    if load_vae:
        bundle.vae_config = vae_config_from_hf(convert.load_component_config(model_dir, "vae"))
        bundle.vae_params = tree_to(convert.load_component(model_dir, "vae"), device, dtype)
    return bundle
