"""FLUX slider inference with the PyTorch port, the flux-sliders inference
flow as a script: FlowMatch-Euler with the resolution shift, the guidance
embedding, the slider gated by step index (on while step > skip_till,
custom_flux_pipeline.py:694-731), one denoise per scale on weights merged
with the slider at that scale. FLUX-dev in bf16 fits one 80 GB card; the
JAX example's pipeline-parallel --pp is not ported (ROADMAP queue 1,
item 15).

Usage:
  python examples/flux_slider_inference_torch.py --base /path/FLUX.1-dev \
      --slider age_flux_last.safetensors --prompt 'portrait photo' \
      --scales '-4,0,4' --skip_till 2
  (--device cpu runs on the CPU; the default is CUDA device 0)
"""

import argparse

import numpy as np


def sweep_latents(models, weights, prompt: str, scales, *, steps: int = 30,
                  skip_till: int = 2, guidance: float = 3.5, size: int = 1024, seed: int = 0,
                  dtype=None, t5_ids=None) -> list:
    """The denoised packed latents of each scale, all from the same initial
    latents (a torch.Generator seeded `seed`)."""
    import torch

    from sliders_tpu_torch.diffusion.schedulers import make_flowmatch_sampler
    from sliders_tpu_torch.pipelines.flux_t2i import (encode_prompts_flux,
                                                      initial_packed_latents,
                                                      make_flux_sampling_fn)

    latent_hw = size // 8
    sampler = make_flowmatch_sampler(num_steps=steps, image_seq_len=(latent_hw // 2) ** 2)
    fn = make_flux_sampling_fn(models.transformer_config, sampler, latent_hw=latent_hw,
                               compute_dtype=dtype or torch.bfloat16)
    pooled, t5e = encode_prompts_flux(models, [prompt], t5_ids=t5_ids)
    lats = initial_packed_latents(torch.Generator().manual_seed(seed), 1, size, size,
                                  models.vae_config.latent_channels).to(pooled.device)
    return [fn(models.transformer_params, lats, pooled, t5e, weights, float(s),
               float(skip_till), float(guidance)) for s in scales]


def main(args):
    import torch

    from sliders_tpu_torch.cli.train_text_slider import resolve_device
    from sliders_tpu_torch.lora import io as lora_io
    from sliders_tpu_torch.models import flux, loader
    from sliders_tpu_torch.models.params import tree_to
    from sliders_tpu_torch.pipelines import text2image as t2i
    from sliders_tpu_torch.serving.server import encode_png

    device = resolve_device(args.device)
    models = loader.load_flux(args.base, device=device, dtype=torch.bfloat16, load_vae=True)
    weights = None
    if args.slider:
        weights = tree_to(lora_io.load_slider(args.slider, models.transformer_params), device)
    scales = [float(s) for s in args.scales.split(",")]
    lats = sweep_latents(models, weights, args.prompt, scales, steps=args.steps,
                         skip_till=args.skip_till, guidance=args.guidance, size=args.size,
                         seed=args.seed)
    latent_hw = args.size // 8
    panels = []
    for s, packed in zip(scales, lats):
        lat = flux.unpack_latents(packed, latent_hw, latent_hw)
        panels.append(t2i.decode_images(models.vae_params, models.vae_config, lat)[0]
                      .cpu().numpy())
        print(f"scale {s:+g} done")
    with open(args.out, "wb") as f:
        f.write(encode_png(np.concatenate(panels, axis=1)))
    print(f"saved {args.out}")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--base", required=True)
    p.add_argument("--slider", default=None)
    p.add_argument("--prompt", required=True)
    p.add_argument("--scales", default="-4,0,4")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--skip_till", type=int, default=2,
                   help="the slider is on while step index > skip_till")
    p.add_argument("--guidance", type=float, default=3.5)
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="0", help="a CUDA ordinal (default 0), cuda[:N] or cpu")
    p.add_argument("--out", default="flux_sweep.png")
    main(p.parse_args())
