"""Model loading from LOCAL diffusers snapshot directories
(port of the SD1, SDXL and FLUX paths of sliders_tpu/models/loader.py).

An SD snapshot holds unet/ text_encoder/ tokenizer/ vae/ subfolders with
config.json and safetensors weights (sharded components load too); an SDXL
snapshot adds text_encoder_2/ (OpenCLIP bigG with its projection) and
tokenizer_2/; a FLUX snapshot holds transformer/ text_encoder/ (CLIP-L)
tokenizer/ text_encoder_2/ (T5) tokenizer_2/ vae/. `load_sd` also takes a
single-file `.ckpt` / `.safetensors` checkpoint in the original LDM layout
(`ldm_checkpoint.py`) with a local tokenizer directory.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional

import torch

from sliders_tpu_torch.models import clip_text, convert, flux, t5, unet2d, vae
from sliders_tpu_torch.models.params import tree_to
from sliders_tpu_torch.text.t5_tokenizer import T5Tokenizer
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
    text_encoders: list  # one CLIP for SD1, CLIP-L and bigG for SDXL
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
    tokenizer_dir: Optional[str] = None,
) -> SDModels:
    """SD1.x / SD2.x diffusers snapshot -> SDModels with every parameter on
    `device` in `dtype`. clip_skip k keeps num_layers - (k - 1) text layers
    (v2 defaults to clip_skip 2, as the reference does).

    `model_dir` may also be a single-file `.ckpt` / `.safetensors`
    checkpoint in the original LDM layout (model_util.py:111-116 dispatch);
    it carries no tokenizer, so it needs `tokenizer_dir` (a local CLIP
    tokenizer directory with vocab.json and merges.txt)."""
    if clip_skip is None and v2:
        clip_skip = 2
    if model_dir.endswith((".ckpt", ".safetensors")):
        return _load_sd_single_file(model_dir, device=device, v2=v2, clip_skip=clip_skip,
                                    dtype=dtype, load_vae=load_vae, tokenizer_dir=tokenizer_dir)
    unet_cfg = unet_config_from_hf(convert.load_component_config(model_dir, "unet"))
    unet_params = tree_to(convert.load_component(model_dir, "unet"), device, dtype)
    te = _load_clip(model_dir, device, dtype)
    if clip_skip is not None:
        te.clip_skip_layers = te.config.num_layers - (clip_skip - 1)
    bundle = SDModels(unet_params, unet_cfg, [te])
    if load_vae:
        _load_vae(bundle, model_dir, device, dtype)
    return bundle


def _load_sd_single_file(path: str, *, device, v2: bool, clip_skip: Optional[int], dtype,
                         load_vae: bool, tokenizer_dir: Optional[str]) -> SDModels:
    """An LDM single file -> SDModels on the SD1.5 configs, or with `v2` on
    SD2.1's UNet and the full 24-layer OpenCLIP text tower that single files
    store (clip_skip truncates it at apply time, model_util.py:48). The VAE
    only under `load_vae`."""
    from sliders_tpu_torch.models import ldm_checkpoint

    if tokenizer_dir is None:
        raise ValueError(
            "single-file checkpoints carry no tokenizer; pass tokenizer_dir "
            "(a local CLIP tokenizer directory with vocab.json/merges.txt)"
        )
    unet_cfg = unet2d.SD21 if v2 else unet2d.SD15
    vae_cfg = vae.SD_VAE
    unet_tree, vae_tree, text_tree = ldm_checkpoint.load_single_file(
        path, unet_cfg, vae_cfg if load_vae else None)
    if unet_tree is None or text_tree is None:
        raise ValueError(f"{path}: missing UNet or text-encoder weights")
    te_cfg = dataclasses.replace(clip_text.CLIP_SD2, num_layers=24) if v2 else clip_text.CLIP_L
    tokenizer = ClipTokenizer.from_pretrained(tokenizer_dir)
    tokenizer.model_max_length = te_cfg.max_positions
    layers = te_cfg.num_layers - (clip_skip - 1) if clip_skip else None
    te = TextEncoderBundle(tokenizer, tree_to(text_tree, device, dtype), te_cfg, layers)
    bundle = SDModels(tree_to(unet_tree, device, dtype), unet_cfg, [te])
    if load_vae and vae_tree is not None:
        bundle.vae_config = vae_cfg
        bundle.vae_params = tree_to(vae_tree, device, dtype)
    return bundle


def _load_vae(bundle, model_dir: str, device, dtype) -> None:
    bundle.vae_config = vae_config_from_hf(convert.load_component_config(model_dir, "vae"))
    bundle.vae_params = tree_to(convert.load_component(model_dir, "vae"), device, dtype)


def _load_clip(model_dir: str, device, dtype, te_sub: str = "text_encoder",
               tok_sub: str = "tokenizer", pad_token_id: Optional[int] = None
               ) -> TextEncoderBundle:
    cfg = clip_config_from_hf(convert.load_component_config(model_dir, te_sub))
    params = tree_to(convert.load_component(model_dir, te_sub), device, dtype)
    tokenizer = ClipTokenizer.from_pretrained(os.path.join(model_dir, tok_sub),
                                              pad_token_id=pad_token_id)
    tokenizer.model_max_length = cfg.max_positions
    return TextEncoderBundle(tokenizer, params, cfg)


def load_sdxl(model_dir: str, *, device="cpu", dtype=torch.bfloat16,
              load_vae: bool = False) -> SDModels:
    """An SDXL diffusers snapshot -> SDModels(is_xl=True) with every
    parameter on `device` in `dtype`: the text_time UNet, CLIP-L and bigG
    (model_util.load_models_xl); tokenizer_2 pads with id 0
    (model_util.py:150)."""
    unet_cfg = unet_config_from_hf(convert.load_component_config(model_dir, "unet"))
    unet_params = tree_to(convert.load_component(model_dir, "unet"), device, dtype)
    te1 = _load_clip(model_dir, device, dtype)
    te2 = _load_clip(model_dir, device, dtype, "text_encoder_2", "tokenizer_2", pad_token_id=0)
    bundle = SDModels(unet_params, unet_cfg, [te1, te2], is_xl=True)
    if load_vae:
        _load_vae(bundle, model_dir, device, dtype)
    return bundle


def flux_config_from_hf(cfg: dict) -> flux.FluxConfig:
    return flux.FluxConfig(
        in_channels=cfg.get("in_channels", 64),
        num_layers=cfg.get("num_layers", 19),
        num_single_layers=cfg.get("num_single_layers", 38),
        attention_head_dim=cfg.get("attention_head_dim", 128),
        num_attention_heads=cfg.get("num_attention_heads", 24),
        joint_attention_dim=cfg.get("joint_attention_dim", 4096),
        pooled_projection_dim=cfg.get("pooled_projection_dim", 768),
        guidance_embeds=cfg.get("guidance_embeds", True),
        axes_dims_rope=tuple(cfg.get("axes_dims_rope", (16, 56, 56))),
    )


def t5_config_from_hf(cfg: dict) -> t5.T5Config:
    return t5.T5Config(
        vocab_size=cfg.get("vocab_size", 32128),
        d_model=cfg.get("d_model", 4096),
        d_kv=cfg.get("d_kv", 64),
        d_ff=cfg.get("d_ff", 10240),
        num_layers=cfg.get("num_layers", 24),
        num_heads=cfg.get("num_heads", 64),
    )


@dataclass
class FluxModels:
    transformer_params: dict
    transformer_config: flux.FluxConfig
    clip: TextEncoderBundle
    t5_params: dict
    t5_config: t5.T5Config
    t5_tokenizer: T5Tokenizer
    vae_params: Optional[dict] = None
    vae_config: Optional[vae.VaeConfig] = None


def load_flux_transformer(model_dir: str, *, device="cpu", dtype=torch.bfloat16,
                          keep=None) -> tuple:
    """(parameters on `device` in `dtype`, FluxConfig) of a FLUX snapshot's
    transformer. `keep(prefix, block)` (`flux.keep_blocks`: a rank's tp
    shard or pipeline stage) runs on the host copy, before the move, so a
    rank's device holds only its part."""
    params = convert.load_component(model_dir, "transformer")
    if keep is not None:
        params = flux.keep_blocks(params, keep)
    return (tree_to(params, device, dtype),
            flux_config_from_hf(convert.load_component_config(model_dir, "transformer")))


def load_flux(model_dir: str, *, device="cpu", dtype=torch.bfloat16,
              load_vae: bool = False, transformer_keep=None) -> FluxModels:
    """A FLUX diffusers snapshot (transformer + CLIP-L + T5 + the 16-channel
    VAE) -> FluxModels with every parameter on `device` in `dtype`. The T5
    tokenizer is the port's own reader of tokenizer_2/tokenizer.json.
    `transformer_keep`: see `load_flux_transformer`."""
    bundle = FluxModels(
        *load_flux_transformer(model_dir, device=device, dtype=dtype, keep=transformer_keep),
        _load_clip(model_dir, device, dtype),
        tree_to(convert.load_component(model_dir, "text_encoder_2"), device, dtype),
        t5_config_from_hf(convert.load_component_config(model_dir, "text_encoder_2")),
        T5Tokenizer.from_pretrained(os.path.join(model_dir, "tokenizer_2")),
    )
    if load_vae:
        _load_vae(bundle, model_dir, device, dtype)
    return bundle
