"""CLIP vision tower + full CLIP (image-text) model for eval scoring
(port of sliders_tpu/models/clip_vision.py).

Replaces the reference eval harness's `CLIPModel.from_pretrained
("openai/clip-vit-base-patch32")` (eval-scripts/clip_score.py:24-25): the
quality gate computes `logits_per_image` between generated images and the
attribute prompt per slider scale. Param trees mirror the transformers
CLIPModel state dict in torch layouts (the patch embedding OIHW).

The tower runs in f32 whatever the weights' dtype, on stock PyTorch ops: the
patch embedding is `F.conv2d` (stride = patch size, no bias), and the
encoder is `clip_text`'s layer without a mask. At ViT-B/32's 50 tokens its
attention takes the plain path (kernel #1's gate wants L >= 1024), as in the
JAX package. Images are NHWC at the interface, as there.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from sliders_tpu_torch.models import clip_text
from sliders_tpu_torch.models.params import ParamFactory, tree_to
from sliders_tpu_torch.ops.basic import layer_norm, linear

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass(frozen=True)
class ClipVisionConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    image_size: int = 224
    patch_size: int = 32
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5


VIT_B32 = ClipVisionConfig()
TINY_VISION = ClipVisionConfig(
    hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
    image_size=16, patch_size=8,
)
# openai/clip-vit-base-patch32's text tower (its vocabulary, 77 positions,
# pooled at the EOS id 49407) and the shared projection width
VIT_B32_TEXT = clip_text.ClipTextConfig(hidden_size=512, num_heads=8, intermediate_size=2048,
                                        projection_dim=512)


def apply_vision(params: dict, pixels: torch.Tensor, cfg: ClipVisionConfig) -> dict:
    """pixels: (B, H, W, 3) normalized. Returns {'last_hidden_state',
    'pooler_output'} in f32."""
    vm = params["vision_model"]
    emb = vm["embeddings"]
    w = emb["patch_embedding"]["weight"].float()
    patches = F.conv2d(pixels.float().permute(0, 3, 1, 2), w, stride=cfg.patch_size)
    x = patches.flatten(2).transpose(1, 2)  # (B, h * w, D), patches row-major
    cls = emb["class_embedding"].float().expand(x.shape[0], 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    x = x + emb["position_embedding"]["weight"][: x.shape[1]].float()

    x = layer_norm(vm["pre_layrnorm"], x, cfg.layer_norm_eps)  # HF's typo'd name
    for i in range(cfg.num_layers):
        x = clip_text._encoder_layer(vm["encoder"]["layers"][str(i)], x, cfg, None)
    pooled = layer_norm(vm["post_layernorm"], x[:, 0], cfg.layer_norm_eps)
    return {"last_hidden_state": x, "pooler_output": pooled}


def clip_logits_per_image(
    params: dict,
    pixels: torch.Tensor,
    input_ids: torch.Tensor,
    vision_cfg: ClipVisionConfig,
    text_cfg: clip_text.ClipTextConfig,
) -> torch.Tensor:
    """transformers CLIPModel.forward().logits_per_image: (B_images,
    B_texts)."""
    img = linear(params["visual_projection"], apply_vision(params, pixels, vision_cfg)[
        "pooler_output"])
    txt = clip_text.apply(params, input_ids, text_cfg)["pooler_output"]
    txt = linear(params["text_projection"], txt)
    img = img / torch.linalg.norm(img, dim=-1, keepdim=True)
    txt = txt / torch.linalg.norm(txt, dim=-1, keepdim=True)
    scale = torch.exp(params["logit_scale"].float())
    return scale * img @ txt.T


def preprocess_images(images, size: int = 224) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> CLIP-normalized float32 (B, size, size, 3):
    shortest-side resize + center crop (CLIPProcessor semantics). The
    resize is Keys' cubic (a = -0.5), antialiased when it shrinks: what
    `jax.image.resize(..., "bicubic")` computes."""
    x = torch.as_tensor(images).float() / 255.0
    B, H, W, _ = x.shape
    ratio = size / min(H, W)
    nh, nw = round(H * ratio), round(W * ratio)
    x = F.interpolate(x.permute(0, 3, 1, 2), size=(nh, nw), mode="bicubic",
                      align_corners=False, antialias=True)
    top, left = (nh - size) // 2, (nw - size) // 2
    x = x[:, :, top: top + size, left: left + size].permute(0, 2, 3, 1)
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=x.device)
    std = torch.tensor(CLIP_IMAGE_STD, device=x.device)
    return (x - mean) / std


def load_clip_model(model_dir: str, device="cpu", dtype=torch.float32):
    """Load a full CLIP (e.g. a local openai/clip-vit-base-patch32 snapshot:
    config.json, safetensors and the tokenizer files at its top level) ->
    (params on `device` in `dtype`, vision_cfg, text_cfg, tokenizer)."""
    from sliders_tpu_torch.models import convert
    from sliders_tpu_torch.models.loader import clip_config_from_hf
    from sliders_tpu_torch.text.tokenizer import ClipTokenizer

    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = json.load(f)
    v, t = cfg["vision_config"], cfg["text_config"]
    vision_cfg = ClipVisionConfig(
        hidden_size=v.get("hidden_size", 768),
        num_layers=v.get("num_hidden_layers", 12),
        num_heads=v.get("num_attention_heads", 12),
        intermediate_size=v.get("intermediate_size", 3072),
        image_size=v.get("image_size", 224),
        patch_size=v.get("patch_size", 32),
        hidden_act=v.get("hidden_act", "quick_gelu"),
    )
    text_cfg = clip_config_from_hf({**t, "projection_dim": cfg.get("projection_dim", 512)})
    state: dict = {}
    for path in convert._component_files(model_dir):
        state.update(convert.read_safetensors(path))
    params = tree_to(convert.convert_state_dict(state), device, dtype)
    tokenizer = ClipTokenizer.from_pretrained(model_dir)
    tokenizer.model_max_length = text_cfg.max_positions
    return params, vision_cfg, text_cfg, tokenizer


def save_clip_model(model_dir: str, params: dict, vision_cfg: ClipVisionConfig,
                    text_cfg: clip_text.ClipTextConfig) -> None:
    """Write `params` as a transformers CLIPModel snapshot that
    `load_clip_model` reads back: config.json and model.safetensors (with
    the models' int64 `position_ids` buffers); the tokenizer files are the
    caller's."""
    from sliders_tpu_torch.models.convert import write_safetensors
    from sliders_tpu_torch.utils.pytree import flatten

    n_patches = (vision_cfg.image_size // vision_cfg.patch_size) ** 2 + 1
    state = {**flatten(params),
             "text_model.embeddings.position_ids": torch.arange(text_cfg.max_positions)[None],
             "vision_model.embeddings.position_ids": torch.arange(n_patches)[None]}
    config = {
        "projection_dim": params["visual_projection"]["weight"].shape[0],
        "vision_config": {
            "hidden_size": vision_cfg.hidden_size, "num_hidden_layers": vision_cfg.num_layers,
            "num_attention_heads": vision_cfg.num_heads,
            "intermediate_size": vision_cfg.intermediate_size,
            "image_size": vision_cfg.image_size, "patch_size": vision_cfg.patch_size,
            "hidden_act": vision_cfg.hidden_act},
        "text_config": {
            "vocab_size": text_cfg.vocab_size, "hidden_size": text_cfg.hidden_size,
            "num_hidden_layers": text_cfg.num_layers,
            "num_attention_heads": text_cfg.num_heads,
            "intermediate_size": text_cfg.intermediate_size,
            "max_position_embeddings": text_cfg.max_positions,
            "hidden_act": text_cfg.hidden_act, "eos_token_id": text_cfg.eos_token_id},
    }
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(config, f)
    write_safetensors(os.path.join(model_dir, "model.safetensors"), state)


def init_params(generator: Optional[torch.Generator], vision_cfg: ClipVisionConfig,
                text_cfg: clip_text.ClipTextConfig, projection_dim: int = 16,
                dtype=torch.float32, device="cpu") -> dict:
    """Random full-CLIP init with the JAX package's distributions (normal *
    0.02, zero biases, unit norms, logit scale 2.6592)."""
    f = ParamFactory(generator, dtype, device)
    d, m = vision_cfg.hidden_size, vision_cfg.intermediate_size
    layers = {}
    for i in range(vision_cfg.num_layers):
        layers[str(i)] = {
            "layer_norm1": f.norm(d),
            "layer_norm2": f.norm(d),
            "self_attn": {name: f.dense(d, d, std=0.02)
                          for name in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "mlp": {"fc1": f.dense(d, m, std=0.02), "fc2": f.dense(m, d, std=0.02)},
        }
    n_pos = (vision_cfg.image_size // vision_cfg.patch_size) ** 2 + 1
    p = vision_cfg.patch_size
    params = clip_text.init_params(generator, text_cfg, dtype=dtype, device=device)
    params.pop("text_projection", None)
    params["vision_model"] = {
        "embeddings": {
            "class_embedding": f.normal((d,), 0.02),
            "patch_embedding": {"weight": f.normal((d, 3, p, p), 0.02).contiguous(
                memory_format=torch.channels_last)},
            "position_embedding": {"weight": f.normal((n_pos, d), 0.02)},
        },
        "pre_layrnorm": f.norm(d),
        "encoder": {"layers": layers},
        "post_layernorm": f.norm(d),
    }
    params["visual_projection"] = f.dense(d, projection_dim, bias=False, std=0.02)
    params["text_projection"] = f.dense(text_cfg.hidden_size, projection_dim, bias=False,
                                        std=0.02)
    params["logit_scale"] = torch.tensor(2.6592, dtype=dtype, device=device)
    return params
