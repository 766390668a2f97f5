"""SD1 slider inference with the PyTorch port: the SD1-sliders-inference
notebook flow as a script. Load a local SD snapshot and a trained slider
(reference .pt checkpoints load directly), sweep scales with start-noise
gating, one denoise per scale on weights merged with the slider at that
scale (the scalar-scale merged-delta path), and save the sweep as one PNG.

Usage:
  python examples/sd1_slider_inference_torch.py --base /path/sd15 \
      --slider age_alpha1.0_rank4_noxattn_last.safetensors \
      --prompt 'photo of a person' --scales '0,1,2,3' --start_noise 800
  (--device cpu runs on the CPU; the default is CUDA device 0)
"""

import argparse

import numpy as np


def sweep_latents(models, weights, prompt: str, scales, *, scheduler: str = "lms",
                  steps: int = 50, start_noise: float = 800.0, guidance: float = 7.5,
                  size: int = 512, seed: int = 0, dtype=None) -> list:
    """The denoised latents of each scale, one merged-path call each, all
    from the same initial latents (and, for ddpm / euler_a, ancestral
    draws): a torch.Generator seeded `seed` for each scale."""
    import torch

    from sliders_tpu_torch.diffusion import make_sampler, make_schedule
    from sliders_tpu_torch.pipelines import text2image as t2i
    from sliders_tpu_torch.pipelines.encoding import encode_prompts

    # the notebook uses the LMS scheduler at 50 steps
    sampler = make_sampler(make_schedule(), scheduler, steps)
    fn = t2i.make_sampling_fn(models.unet_config, sampler,
                              compute_dtype=dtype or torch.bfloat16)
    te = models.text_encoders[0]
    cond = encode_prompts(te.tokenizer, te.params, te.config, [prompt])
    uncond = encode_prompts(te.tokenizer, te.params, te.config, [""])
    out = []
    for s in scales:
        gen = torch.Generator().manual_seed(seed)
        lats = t2i.initial_latents(gen, 1, size, size, sampler.init_noise_sigma)
        out.append(fn(models.unet_params, lats.to(cond.device), cond, uncond, weights, float(s),
                      float(start_noise), float(guidance),
                      generator=gen if sampler.stochastic else None))
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
    models = loader.load_sd(args.base, device=device, dtype=torch.bfloat16, load_vae=True)
    weights = None
    if args.slider:
        weights = tree_to(lora_io.load_slider(args.slider, models.unet_params), device)
    scales = [float(s) for s in args.scales.split(",")]
    lats = sweep_latents(models, weights, args.prompt, scales, scheduler=args.scheduler,
                         steps=args.steps, start_noise=args.start_noise, guidance=args.guidance,
                         size=args.size, seed=args.seed)
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
    p.add_argument("--scales", default="0,1,2,3")
    p.add_argument("--start_noise", type=int, default=800)
    p.add_argument("--guidance", type=float, default=7.5)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--scheduler", default="lms")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="0", help="a CUDA ordinal (default 0), cuda[:N] or cpu")
    p.add_argument("--out", default="slider_sweep.png")
    main(p.parse_args())
