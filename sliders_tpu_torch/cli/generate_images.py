"""CSV-driven scale-sweep image generation, the reference eval generators
(eval-scripts/generate_images_sd1.py / generate_images_xl.py) as one CLI
(port of sliders_tpu/cli/generate_images.py).

  python -m sliders_tpu_torch.cli.generate_images --base /path/sd15 \
      --model_name out/age_alpha1.0_rank4_noxattn_last.safetensors \
      --prompts_path prompts.csv --save_path images [--scales -2,-1,0,1,2]
  python -m sliders_tpu_torch.cli.generate_images --xl --base /path/sdxl-turbo \
      --scheduler euler_a --ddim_steps 3 --guidance_scale 1 --start_noise 700 ...

Per CSV row (case_number, prompt, evaluation_seed) and slider scale, sample
with the slider gated by start_noise and save
`{save_path}/{name}/{scale}/{case_number}_{i}.png` plus the row of the
sweep as one image under `all/`: the layout the CLIP / LPIPS scorers read.
The whole sweep of one row (samples x scales) is one batched denoise with
per-row slider multipliers; guidance 1 or less runs without CFG. Sample i's
initial latents are drawn from a torch.Generator seeded `seed + i * 1000`
and tiled over the scales; the ancestral samplers' per-step noise comes
from sample 0's generator after its latents. The VAE decodes `decode_rows`
rows a call, as the server does.

The slider's sweep comes from its `_metadata.json` sidecar when present,
else from the checkpoint's name as the reference parses it
(generate_images_sd1.py:80-104); hspace / last sliders widen it to +-5.
`--compose CKPT:SCALE` (repeatable) sweeps the rank concatenation of
several sliders (lora/compose.py) at global multipliers 0, 1.

The card's machine has no pandas and no Pillow: the CSV is read with the
`csv` module the way pandas.read_csv reads it (`read_prompts_csv`), PNGs
are written by `serving.server.encode_png`. Not ported yet: --fleet
(ROADMAP queue 1, item 14) and --dp other than 1 (item 15).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time

import numpy as np

from sliders_tpu_torch.evals.scoring import PANDAS_NA, read_table  # noqa: F401

DEFAULT_SCALES = [-2.0, -1.0, 0.0, 1.0, 2.0]
HSPACE_SCALES = [-5.0, -2.0, -1.0, 0.0, 1.0, 2.0, 5.0]


def infer_params_from_name(model_path: str) -> dict:
    """The reference checkpoint-layout hyperparameter parsing
    (eval-scripts/generate_images_sd1.py:78-91), with the JAX package's
    extensions: the method fragments are read from the file name (our
    save convention, `_alpha{a}_rank{r}_{method}`, its `_last` /
    `_{i}steps` suffix stripped) or else the parent directory (the
    reference's); exact method tokens first, then the reference's fragment
    composition; hspace / last widen the sweep to +-5; rank / alpha tokens
    from either component."""
    parent = os.path.basename(os.path.dirname(os.path.abspath(model_path)))
    base = os.path.basename(model_path).replace(".safetensors", "").replace(".pt", "")
    base = re.sub(r"_(last|\d+steps)$", "", base)

    def method_tokens(s: str) -> set:
        # underscore tokens and their hyphen parts: 'ballast' or 'fullface'
        # never match a fragment by substring
        toks = set()
        for t in s.split("_"):
            toks.add(t)
            toks.update(t.split("-"))
        return toks

    fragments = {"xattn", "noxattn", "hspace", "last", "full", "selfattn", "innoxattn",
                 "xattn-strict"}
    base_toks, parent_toks = method_tokens(base), method_tokens(parent)
    toks = base_toks if base_toks & fragments else parent_toks

    out = {"rank": 4, "alpha": 1.0, "scales": list(DEFAULT_SCALES)}
    method = None
    for m in ("noxattn-hspace-last", "noxattn-hspace", "xattn-strict", "innoxattn", "noxattn",
              "selfattn", "xattn", "full"):
        if m in toks:
            method = m
            break
    if method is None:  # the reference's fragment composition
        method = "xattn"
        if "noxattn" in toks:
            method = "noxattn"
        if "hspace" in toks:
            method += "-hspace"
        if "last" in toks:
            method += "-last"
    if "hspace" in toks or "last" in toks:
        out["scales"] = list(HSPACE_SCALES)
    out["train_method"] = method
    out["network_type"] = "lierla" if method == "xattn" else "c3lier"

    for token in (parent + "_" + base).split("_"):
        if token.startswith("rank"):
            try:
                out["rank"] = int(token[4:])
            except ValueError:
                pass
        if token.startswith("alpha"):
            try:
                out["alpha"] = float(token[5:])
            except ValueError:
                pass
    return out


def _infer_scales(model_path: str) -> list:
    """The sweep from the metadata sidecar when present, else from the
    checkpoint path."""
    meta_path = model_path.rsplit("_", 1)[0] + "_metadata.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        method = meta.get("config", {}).get("network", {}).get("training_method", "")
        print(f"slider hyperparams from {meta_path}")
        if "hspace" in method or "last" in method:
            return list(HSPACE_SCALES)
        return list(DEFAULT_SCALES)
    inferred = infer_params_from_name(model_path)
    print(f"slider hyperparams from checkpoint path: {inferred}")
    return inferred["scales"]


def scale_folder_name(scale: float) -> str:
    """The folder of one scale, by the reference expression, quirks kept:
    0.5 -> 'half', -0.5 -> '-half', 10.5 -> '1half', 1.0 -> '1', 0.0 -> '0'."""
    s = str(scale)
    name = s.replace("0.5", "half").rstrip("0").rstrip(".") if "." in s else s
    return name or "0"


def read_prompts_csv(path: str) -> list:
    """(case_number, prompt, evaluation_seed) per row of a prompts CSV, as
    int(row.case_number), str(row.prompt), int(row.evaluation_seed) give
    them from pandas.read_csv (`evals.scoring.read_table`): quoted fields
    with commas, blank lines skipped, an NA cell as the prompt 'nan', '11.0'
    as the seed 11."""
    table = read_table(path)
    if not next(iter(table.values()), []):
        return []
    missing = {"case_number", "prompt", "evaluation_seed"} - set(table)
    if missing:
        raise ValueError(f"{path}: no column(s) {sorted(missing)}")
    return [(int(c), str(p), int(s)) for c, p, s in
            zip(table["case_number"], table["prompt"], table["evaluation_seed"])]


def decode_batches(models, x, image_size: int) -> np.ndarray:
    """Latents -> uint8 (B, H, W, 3) on the host, `decode_rows_for(image_size)`
    rows a VAE call, as the server decodes."""
    from sliders_tpu_torch.pipelines import text2image as t2i
    from sliders_tpu_torch.serving.server import decode_rows_for

    rows = decode_rows_for(image_size)
    return np.concatenate([
        t2i.decode_images(models.vae_params, models.vae_config, x[i:i + rows]).cpu().numpy()
        for i in range(0, len(x), rows)])


def write_png(path: str, img: np.ndarray) -> None:
    from sliders_tpu_torch.serving.server import encode_png

    with open(path, "wb") as f:
        f.write(encode_png(img))


def _stem(path: str) -> str:
    return os.path.basename(path).replace(".pt", "").replace(".safetensors", "")


def main(args) -> dict:
    """Run the CLI; returns {"folders": [...], "cases": [(case, seconds),
    ...]} for in-process callers."""
    if args.fleet:
        raise NotImplementedError("--fleet (several sliders in one sweep) is not ported yet "
                                  "(ROADMAP queue 1, item 14)")
    if args.dp != 1:
        raise NotImplementedError("--dp: a data-parallel sweep is not ported yet "
                                  "(ROADMAP queue 1, item 15)")
    if args.compose and args.model_name:
        raise SystemExit("--compose conflicts with --model_name; fold the named slider into "
                         "the composition as another --compose CKPT:SCALE entry")
    compose = []
    for entry in args.compose or []:
        path, _, s = entry.rpartition(":")
        try:
            compose.append((path, float(s)))
        except ValueError:
            path = ""
        if not path:
            raise SystemExit(f"--compose wants CKPT:SCALE, got {entry!r}")

    import torch

    from sliders_tpu_torch.cli.train_text_slider import resolve_device
    from sliders_tpu_torch.diffusion import make_sampler, make_schedule
    from sliders_tpu_torch.lora import io as lora_io
    from sliders_tpu_torch.lora.compose import compose_sliders
    from sliders_tpu_torch.models import loader
    from sliders_tpu_torch.models.params import tree_to
    from sliders_tpu_torch.pipelines import text2image as t2i

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.precision in ("bf16", "bfloat16") else torch.float32
    if args.xl:
        models = loader.load_sdxl(args.base, device=device, dtype=dtype, load_vae=True)
    else:
        models = loader.load_sd(args.base, device=device, v2=args.v2, clip_skip=args.clip_skip,
                                dtype=dtype, load_vae=True)

    weights = None
    inferred_scales = list(DEFAULT_SCALES)
    if compose:
        # the swept scale multiplies the whole composition (1 = nominal)
        weights = compose_sliders([(lora_io.load_slider(p, models.unet_params), s)
                                   for p, s in compose])
        inferred_scales = [0.0, 1.0]  # base against composed, unless --scales
        # the per-adapter scales are in the name: another run with other
        # scales lands in another folder
        name = "compose_" + "+".join(f"{_stem(p)}_{e.rpartition(':')[2]}"
                                     for (p, _), e in zip(compose, args.compose))
    else:
        if args.model_name:
            weights = lora_io.load_slider(args.model_name, models.unet_params)
            inferred_scales = _infer_scales(args.model_name)
        name = _stem(args.model_name or "base")
    if weights is not None:
        weights = tree_to(weights, device)
    scales = ([float(s) for s in args.scales.split(",")] if args.scales is not None
              else inferred_scales)

    sampler = make_sampler(make_schedule(), args.scheduler, args.ddim_steps)
    fn = t2i.make_sampling_fn(models.unet_config, sampler, use_cfg=args.guidance_scale > 1.0,
                              guidance_rescale=0.7 if args.xl else 0.0, compute_dtype=dtype)

    folder = os.path.join(args.save_path, name)
    scale_strs = [scale_folder_name(s) for s in scales]
    for sub in ["all", *scale_strs]:
        os.makedirs(os.path.join(folder, sub), exist_ok=True)

    n_scales, n_samples = len(scales), args.num_samples
    n_total = n_samples * n_scales
    scale_all = torch.tensor(scales * n_samples, dtype=torch.float32)
    cases = []
    for case, prompt, seed in read_prompts_csv(args.prompts_path):
        if not args.from_case <= case <= args.till_case:
            continue
        print(prompt, seed)
        t0 = time.perf_counter()
        cond, uncond, added1 = t2i.encode_conditioning(models, prompt,
                                                       args.negative_prompt or "",
                                                       args.image_size)
        # rows sample-major: [(s0, scale0), (s0, scale1), ..., (s1, scale0), ...]
        gens = [torch.Generator().manual_seed(seed + i * 1000) for i in range(n_samples)]
        lats = torch.cat([t2i.initial_latents(g, 1, args.image_size, args.image_size,
                                              sampler.init_noise_sigma).expand(n_scales, -1, -1,
                                                                               -1)
                          for g in gens])
        cond_b, uncond_b, added_b = t2i.tile_conditioning(cond, uncond, added1, n_total)
        x = fn(models.unet_params, lats.to(device), cond_b, uncond_b, weights, scale_all,
               float(args.start_noise), float(args.guidance_scale), added_b,
               generator=gens[0] if sampler.stochastic else None)
        if not torch.isfinite(x).all():
            raise FloatingPointError(f"case {case}: the denoised latents are not finite")
        imgs = decode_batches(models, x, args.image_size)
        for i in range(n_samples):
            row = imgs[i * n_scales:(i + 1) * n_scales]
            for s_str, img in zip(scale_strs, row):
                write_png(os.path.join(folder, s_str, f"{case}_{i}.png"), img)
            write_png(os.path.join(folder, "all", f"{case}_{i}.png"),
                      np.concatenate(list(row), axis=1))
        seconds = time.perf_counter() - t0
        cases.append((case, seconds))
        print(f"case {case}: {n_total} images in {seconds:.2f} s")
    return {"folders": [folder], "cases": cases}


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model_name", default=None,
                   help="slider checkpoint (.pt/.safetensors); omit for the base model")
    p.add_argument("--compose", action="append", default=None, metavar="CKPT:SCALE",
                   help="compose several sliders (repeatable), each at its own signed scale; "
                        "the swept scales multiply the composition (default sweep 0,1)")
    p.add_argument("--fleet", action="append", default=None, metavar="CKPT",
                   help="several sliders in one sweep (not ported yet: ROADMAP item 14)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel devices (only 1 is ported: ROADMAP item 15)")
    p.add_argument("--prompts_path", required=True,
                   help="csv with case_number,prompt,evaluation_seed")
    p.add_argument("--save_path", required=True)
    p.add_argument("--base", required=True, help="local model snapshot dir")
    p.add_argument("--device", default="0", help="a CUDA ordinal (default 0), cuda[:N] or cpu")
    p.add_argument("--negative_prompt", default=None)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--num_samples", type=int, default=1)
    p.add_argument("--from_case", type=int, default=0)
    p.add_argument("--till_case", type=int, default=1000000)
    p.add_argument("--start_noise", type=int, default=750)
    p.add_argument("--scales", type=str, default=None,
                   help="comma-separated sweep; default -2..2, widened to +-5 for hspace/last "
                        "sliders")
    p.add_argument("--scheduler", type=str, default="ddim",
                   choices=["ddim", "ddpm", "lms", "euler_a"])
    p.add_argument("--precision", type=str, default="bfloat16")
    p.add_argument("--xl", action="store_true")
    p.add_argument("--v2", action="store_true", help="SD2.x base model")
    p.add_argument("--clip_skip", type=int, default=None)
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
