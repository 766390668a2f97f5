"""Per-word cross-attention maps with the PyTorch port: the reference's
show_cross_attention diagnostics (trainscripts/textsliders/ptp_utils.py:
243-295, via demo_image_editing.ipynb) as a script.

One UNet forward at a chosen timestep under an attention tap; the
cross-attention maps of the up and down blocks at --res x --res are
averaged, and one grayscale heat map per prompt token is saved (optionally
with a slider applied at a scale, to see how it shifts the attention). In
f32; the tapped calls run the plain attention path, which materialises the
probabilities, and every other call keeps its kernel route.

Usage:
  python examples/attention_maps_torch.py --base /path/sd15 \
      --prompt 'photo of an old person' --t 501 --out maps/ \
      [--slider age_last.safetensors --scale 2.0] [--res 16]
  (--device cpu runs on the CPU; the default is CUDA device 0)
"""

import argparse
import os

import numpy as np


def word_maps(models, prompt: str, *, t: float = 501.0, size: int = 512, res: int = 16,
              seed: int = 0, weights=None, scale: float = 1.0, attn_filter=None) -> tuple:
    """(eps, raw tap store, {"pos:token": (res, res) map}) of one UNet
    forward on seeded unit-normal latents at timestep `t`."""
    import torch

    from sliders_tpu_torch.ops.basic import SliderLora
    from sliders_tpu_torch.pipelines import text2image as t2i
    from sliders_tpu_torch.pipelines.attention_control import (aggregate_attention, group_store,
                                                               make_attention_maps_fn,
                                                               word_attention_maps)
    from sliders_tpu_torch.pipelines.encoding import encode_prompts

    te = models.text_encoders[0]
    ehs = encode_prompts(te.tokenizer, te.params, te.config, [prompt])
    latents = t2i.initial_latents(torch.Generator().manual_seed(seed), 1, size, size, 1.0)
    lora = None if weights is None else SliderLora(weights=weights, multiplier=float(scale))
    eps, raw = make_attention_maps_fn(models.unet_config, attn_filter=attn_filter)(
        models.unet_params, latents.to(ehs.device), torch.tensor([float(t)]), ehs, lora=lora)
    agg = aggregate_attention(group_store(raw), res, from_where=("up", "down"), is_cross=True)
    return eps, raw, word_attention_maps(te.tokenizer, prompt, agg)


def save_maps(maps: dict, out: str) -> list:
    """Each (res, res) map, scaled up 16 times, as a gray PNG under `out`;
    returns the file names."""
    from sliders_tpu_torch.serving.server import encode_png

    os.makedirs(out, exist_ok=True)
    names = []
    for name, m in maps.items():
        gray = (np.kron(m, np.ones((16, 16))) * 255).astype(np.uint8)
        names.append(name.replace(":", "_").replace("/", "_") + ".png")
        with open(os.path.join(out, names[-1]), "wb") as f:
            f.write(encode_png(np.repeat(gray[..., None], 3, axis=-1)))
    return names


def main(args):
    import torch

    from sliders_tpu_torch.cli.train_text_slider import resolve_device
    from sliders_tpu_torch.lora import io as lora_io
    from sliders_tpu_torch.models import loader
    from sliders_tpu_torch.models.params import tree_to

    device = resolve_device(args.device)
    models = loader.load_sd(args.base, device=device, dtype=torch.float32)
    weights = None
    if args.slider:
        weights = tree_to(lora_io.load_slider(args.slider, models.unet_params), device)
    _, _, maps = word_maps(models, args.prompt, t=args.t, size=args.size, res=args.res,
                           seed=args.seed, weights=weights, scale=args.scale)
    for (name, m), file in zip(maps.items(), save_maps(maps, args.out)):
        print(f"{name}: peak {m.max():.3f} -> {file}")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--base", required=True, help="local SD snapshot dir")
    p.add_argument("--prompt", required=True)
    p.add_argument("--slider", default=None)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--t", type=int, default=501, help="diffusion timestep")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--res", type=int, default=16, help="map resolution to aggregate")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="0", help="a CUDA ordinal (default 0), cuda[:N] or cpu")
    p.add_argument("--out", default="attention_maps")
    main(p.parse_args())
