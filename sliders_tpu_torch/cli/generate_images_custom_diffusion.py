"""Custom-diffusion baseline generator — the reference's
eval-scripts/generate_images_customdiffusion.py:788-814 CLI (port of
sliders_tpu/cli/generate_images_custom_diffusion.py).

  python -m sliders_tpu_torch.cli.generate_images_custom_diffusion \
      --base /path/sdxl-base-1.0 --model_name runs/eyebrows/delta.pt \
      --token '<sks-eyebrows>' --prompts_path prompts.csv [--compress]

Load an SDXL base, apply a custom-diffusion delta checkpoint (modifier
token embeddings into BOTH encoders + attn2 projections over the UNet,
`--compress` for {'u','v'} low-rank deltas), then for each CSV row sample
`"{prompt} with {token}"` with DDIM (50 steps, CFG 7.5, 1024 px by
default) and save `{save_path}/{run}/{case_number}_{i}.png`, `run` the
checkpoint's folder name. A row's latents are drawn from
`torch.Generator().manual_seed(evaluation_seed)`. Runs on CUDA device 0
unless `--device` says otherwise (`--device cpu` for the CPU).
"""

from __future__ import annotations

import argparse
import os
import time


def main(args) -> dict:
    """Run the CLI; returns {"folder": ..., "cases": [(case, seconds), ...],
    "text_encoders": the bundles with the modifier token} for in-process
    callers."""
    import torch

    from sliders_tpu_torch.cli.generate_images import (decode_batches, read_prompts_csv,
                                                       write_png)
    from sliders_tpu_torch.cli.train_text_slider import resolve_device
    from sliders_tpu_torch.diffusion import make_sampler, make_schedule
    from sliders_tpu_torch.evals.baselines import load_custom_diffusion
    from sliders_tpu_torch.models import loader
    from sliders_tpu_torch.pipelines import text2image as t2i

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.precision in ("bf16", "bfloat16") else torch.float32
    models = loader.load_sdxl(args.base, device=device, dtype=dtype, load_vae=True)
    tes = models.text_encoders
    models.unet_params, te_params = load_custom_diffusion(
        args.model_name, models.unet_params, [te.tokenizer for te in tes],
        [te.params for te in tes], compress=args.compress)
    for te, params in zip(tes, te_params):
        te.params = params

    sampler = make_sampler(make_schedule(), "ddim", args.ddim_steps)
    fn = t2i.make_sampling_fn(models.unet_config, sampler, guidance_rescale=0.0,
                              compute_dtype=dtype)

    run = os.path.basename(os.path.dirname(os.path.abspath(args.model_name)))
    folder = os.path.join(args.save_path, run)
    os.makedirs(folder, exist_ok=True)

    B = args.num_samples
    cases = []
    for case, prompt, seed in read_prompts_csv(args.prompts_path):
        if not args.from_case <= case <= args.till_case:
            continue
        prompt = f"{prompt} with {args.token}"
        print(prompt, seed)
        t0 = time.perf_counter()
        cond, uncond, added = t2i.tile_conditioning(
            *t2i.encode_conditioning(models, prompt, "", args.image_size), B)
        lats = t2i.initial_latents(torch.Generator().manual_seed(seed), B, args.image_size,
                                   args.image_size, sampler.init_noise_sigma)
        x = fn(models.unet_params, lats.to(device), cond, uncond, None, 0.0, -1.0,
               float(args.guidance_scale), added)
        for i, img in enumerate(decode_batches(models, x, args.image_size)):
            write_png(os.path.join(folder, f"{case}_{i}.png"), img)
        cases.append((case, time.perf_counter() - t0))
    return {"folder": folder, "cases": cases, "text_encoders": tes}


def build_parser():
    p = argparse.ArgumentParser(prog="Generate Custom Diffusion Images")
    p.add_argument("--model_name", required=True,
                   help="path to custom-diffusion delta checkpoint (.pt)")
    p.add_argument("--prompts_path", required=True,
                   help="csv with case_number,prompt,evaluation_seed")
    p.add_argument("--token", required=True, help="modifier token, e.g. '<sks-eyebrows>'")
    p.add_argument("--base", required=True, help="local SDXL snapshot dir")
    p.add_argument("--save_path", default="images/customdiffusion")
    p.add_argument("--device", default="0", help="a CUDA ordinal (default 0), cuda[:N] or cpu")
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--image_size", type=int, default=1024)
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--num_samples", type=int, default=5)
    p.add_argument("--from_case", type=int, default=0)
    p.add_argument("--till_case", type=int, default=1000000)
    p.add_argument("--compress", action="store_true", help="low-rank {'u','v'} additive deltas")
    p.add_argument("--precision", default="bfloat16")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
