"""SDXL-Turbo few-step slider inference with the PyTorch port, the
demo_SDXL_Turbo notebook as a script: Euler-ancestral, 3 steps, guidance 1
(no CFG row doubling), slider gated at start_noise 700, one denoise per
scale on weights merged with the slider at that scale.

Usage:
  python examples/sdxl_turbo_slider_torch.py --base /path/sdxl-turbo \
      --slider muscular_last.safetensors --prompt 'photo of a man' --scales '-2,0,2'
  (--device cpu runs on the CPU; the default is CUDA device 0)
"""

import argparse

import numpy as np


def sweep_latents(models, weights, prompt: str, scales, *, steps: int = 3,
                  start_noise: float = 700.0, size: int = 512, seed: int = 0, dtype=None) -> list:
    """The denoised latents of each scale, all from the same initial
    latents and ancestral draws (a torch.Generator seeded `seed` for each
    scale)."""
    import torch

    from sliders_tpu_torch.diffusion import make_sampler, make_schedule
    from sliders_tpu_torch.pipelines import text2image as t2i
    from sliders_tpu_torch.pipelines.encoding import encode_prompts_xl

    sampler = make_sampler(make_schedule(), "euler_a", steps)
    fn = t2i.make_sampling_fn(models.unet_config, sampler, use_cfg=False,
                              compute_dtype=dtype or torch.bfloat16)
    tes = models.text_encoders
    cond, pooled = encode_prompts_xl([te.tokenizer for te in tes], [te.params for te in tes],
                                     [te.config for te in tes], [prompt])
    added = {"text_embeds": pooled, "time_ids": t2i.get_add_time_ids(size, size)}
    out = []
    for s in scales:
        gen = torch.Generator().manual_seed(seed)
        lats = t2i.initial_latents(gen, 1, size, size, sampler.init_noise_sigma)
        out.append(fn(models.unet_params, lats.to(cond.device), cond, None, weights, float(s),
                      float(start_noise), 1.0, added, generator=gen))
    return out


def main(args):
    import torch

    from sliders_tpu_torch.cli.train_text_slider import resolve_device
    from sliders_tpu_torch.lora import io as lora_io
    from sliders_tpu_torch.models import loader
    from sliders_tpu_torch.models.params import tree_to
    from sliders_tpu_torch.pipelines import text2image as t2i
    from sliders_tpu_torch.serving.server import encode_png

    device = resolve_device(args.device)
    models = loader.load_sdxl(args.base, device=device, dtype=torch.bfloat16, load_vae=True)
    weights = None
    if args.slider:
        weights = tree_to(lora_io.load_slider(args.slider, models.unet_params), device)
    scales = [float(s) for s in args.scales.split(",")]
    lats = sweep_latents(models, weights, args.prompt, scales, steps=args.steps, size=args.size,
                         seed=args.seed)
    panels = []
    for s, x in zip(scales, lats):
        panels.append(t2i.decode_images(models.vae_params, models.vae_config, x)[0].cpu().numpy())
        print(f"scale {s:+g} done")
    with open(args.out, "wb") as f:
        f.write(encode_png(np.concatenate(panels, axis=1)))
    print(f"saved {args.out}")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--base", required=True)
    p.add_argument("--slider", default=None)
    p.add_argument("--prompt", required=True)
    p.add_argument("--scales", default="-2,0,2")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="0", help="a CUDA ordinal (default 0), cuda[:N] or cpu")
    p.add_argument("--out", default="turbo_sweep.png")
    main(p.parse_args())
