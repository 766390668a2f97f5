"""A tiny SD or SDXL snapshot written by the port: the layout and configs of
helpers.make_tiny_snapshot, the weights drawn from a seed with no JAX
start-up."""

import json
import os

import torch
from helpers import clip_hf_config, make_tokenizer_files, unet_hf_config, vae_hf_config

from sliders_tpu_torch.models import clip_text, unet2d, vae
from sliders_tpu_torch.models.convert import write_safetensors
from sliders_tpu_torch.utils.pytree import flatten


def write_tiny_snapshot(root, xl: bool = False) -> str:
    """helpers.make_tiny_snapshot's layout and configs, its weights drawn by
    the port from a seed (no JAX start-up)."""
    gen = torch.Generator().manual_seed(20 + xl)
    vocab = make_tokenizer_files(os.path.join(root, "tokenizer"))
    eos = vocab["<|endoftext|>"]
    width = 16 if xl else unet2d.TINY.cross_attention_dim
    encoders = {"text_encoder": clip_text.ClipTextConfig(
        vocab_size=len(vocab), hidden_size=width, num_layers=2, num_heads=2,
        intermediate_size=2 * width, max_positions=16, eos_token_id=eos)}
    if xl:
        make_tokenizer_files(os.path.join(root, "tokenizer_2"))
        encoders["text_encoder_2"] = clip_text.ClipTextConfig(
            vocab_size=len(vocab), hidden_size=16, num_layers=2, num_heads=2,
            intermediate_size=32, max_positions=16, eos_token_id=eos, hidden_act="gelu",
            projection_dim=16)
    ucfg = unet2d.TINY_XL if xl else unet2d.TINY
    parts = {sub: (clip_text.init_params(gen, cfg), clip_hf_config(cfg), "model")
             for sub, cfg in encoders.items()}
    parts["unet"] = (unet2d.init_params(gen, ucfg), unet_hf_config(ucfg),
                     "diffusion_pytorch_model")
    parts["vae"] = (vae.init_params(gen, vae.TINY), vae_hf_config(vae.TINY),
                    "diffusion_pytorch_model")
    for sub, (params, config, stem) in parts.items():
        os.makedirs(os.path.join(root, sub))
        with open(os.path.join(root, sub, "config.json"), "w") as f:
            json.dump(config, f)
        write_safetensors(os.path.join(root, sub, f"{stem}.safetensors"), flatten(params))
    return str(root)
