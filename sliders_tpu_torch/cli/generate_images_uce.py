"""UCE baseline generator — the reference's
eval-scripts/generate_images-uce.py:193-274 CLI (port of
sliders_tpu/cli/generate_images_uce.py).

  python -m sliders_tpu_torch.cli.generate_images_uce --base /path/sd15 \
      --model_name uce_age.pt --prompts_path prompts.csv --save_path images

Load an SD base and a UCE-edited full UNet state_dict (.pt), and for each
CSV row and each scale in [-2,-1,-.5,0,.5,1,2] sample with the
weight-interpolated UNet ``old + scale * (edited - old)`` swapped in at the
start_noise boundary (base weights while t > start_noise). Output layout
matches the reference: `{save_path}/{name}/{scale}/{case_number}_{i}.png`
plus an `all/` strip, `name` the checkpoint's file name without `.pt`.

Each scale is one denoise of `--num_samples` rows (LMS by default, as the
reference); the interpolated tree is formed once a scale, at its first
gated step. A row's latents are drawn from
`torch.Generator().manual_seed(evaluation_seed)`, anew for every scale, so
that every scale starts from the same noise (and the ancestral samplers
draw the same step noise after it). Runs on CUDA device 0 unless
`--device` says otherwise (`--device cpu` for the CPU).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

DEFAULT_SCALES = (-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0)


def main(args) -> dict:
    """Run the CLI; returns {"folder": ..., "cases": [(case, seconds), ...],
    "models": the base models, "edited_params": the UCE UNet} for in-process
    callers."""
    import torch

    from sliders_tpu_torch.cli.generate_images import (decode_batches, read_prompts_csv,
                                                       scale_folder_name, write_png)
    from sliders_tpu_torch.cli.train_text_slider import resolve_device
    from sliders_tpu_torch.diffusion import make_sampler, make_schedule
    from sliders_tpu_torch.evals.baselines import load_uce_unet, make_uce_sampling_fn
    from sliders_tpu_torch.models import loader
    from sliders_tpu_torch.pipelines import text2image as t2i
    from sliders_tpu_torch.pipelines.encoding import encode_prompts

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.precision in ("bf16", "bfloat16") else torch.float32
    models = loader.load_sd(args.base, device=device, v2=args.v2, dtype=dtype, load_vae=True)
    edited_params = load_uce_unet(args.model_name, models.unet_params)

    # the reference samples UCE with LMSDiscreteScheduler (generate_images-uce.py:62)
    sampler = make_sampler(make_schedule(), args.scheduler, args.ddim_steps)
    fn = make_uce_sampling_fn(models.unet_config, sampler, compute_dtype=dtype)

    scales = ([float(s) for s in args.scales.split(",")] if args.scales is not None
              else list(DEFAULT_SCALES))
    name = os.path.basename(args.model_name).replace(".pt", "")
    folder = os.path.join(args.save_path, name)
    scale_strs = [scale_folder_name(s) for s in scales]
    for sub in ["all", *scale_strs]:
        os.makedirs(os.path.join(folder, sub), exist_ok=True)

    te = models.text_encoders[0]
    B = args.num_samples
    cases = []
    for case, prompt, seed in read_prompts_csv(args.prompts_path):
        if not args.from_case <= case <= args.till_case:
            continue
        print(prompt, seed)
        t0 = time.perf_counter()
        cond = encode_prompts(te.tokenizer, te.params, te.config, [prompt]).expand(B, -1, -1)
        uncond = encode_prompts(te.tokenizer, te.params, te.config, [""]).expand(B, -1, -1)
        per_scale = []
        for scale in scales:
            gen = torch.Generator().manual_seed(seed)
            lats = t2i.initial_latents(gen, B, args.image_size, args.image_size,
                                       sampler.init_noise_sigma)
            x = fn(models.unet_params, edited_params, lats.to(device), cond, uncond, scale,
                   float(args.start_noise), float(args.guidance_scale),
                   generator=gen if sampler.stochastic else None)
            per_scale.append(decode_batches(models, x, args.image_size))
        for i in range(B):
            for s_str, imgs in zip(scale_strs, per_scale):
                write_png(os.path.join(folder, s_str, f"{case}_{i}.png"), imgs[i])
            write_png(os.path.join(folder, "all", f"{case}_{i}.png"),
                      np.concatenate([imgs[i] for imgs in per_scale], axis=1))
        cases.append((case, time.perf_counter() - t0))
    return {"folder": folder, "cases": cases, "models": models, "edited_params": edited_params}


def build_parser():
    p = argparse.ArgumentParser(prog="generateImages",
                                description="Generate images with a UCE-edited UNet")
    p.add_argument("--model_name", required=True, help="UCE-edited UNet state_dict (.pt)")
    p.add_argument("--prompts_path", required=True,
                   help="csv with case_number,prompt,evaluation_seed")
    p.add_argument("--base", required=True, help="local SD snapshot dir")
    p.add_argument("--save_path", required=True)
    p.add_argument("--device", default="0", help="a CUDA ordinal (default 0), cuda[:N] or cpu")
    p.add_argument("--v2", action="store_true")
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--num_samples", type=int, default=5)
    p.add_argument("--from_case", type=int, default=0)
    p.add_argument("--till_case", type=int, default=1000000)
    p.add_argument("--start_noise", type=int, default=800)
    p.add_argument("--scales", default=None, help="comma-separated; default -2,-1,-0.5,0,0.5,1,2")
    p.add_argument("--scheduler", default="lms")
    p.add_argument("--precision", default="bfloat16")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
