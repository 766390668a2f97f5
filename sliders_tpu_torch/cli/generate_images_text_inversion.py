"""Textual-inversion baseline generator — the reference's
eval-scripts/generate_images_textinversion.py (SD1: a pipeline with the
learned token baked in, prompt suffixed `" with {token}"`) and
generate_images_textinversion_xl.py:9-27 (SDXL: a learned {'emb','emb2'}
pair written into BOTH encoders' embedding rows via set_XLembedding);
port of sliders_tpu/cli/generate_images_text_inversion.py.

  python -m sliders_tpu_torch.cli.generate_images_text_inversion \
      --model_name /path/sd15 --prompts_path prompts.csv \
      --token '<sks-eyes>' --embedding_file learned_embeds.pt [--xl]

Unified CLI over the same CSV contract (case_number,prompt,evaluation_seed):
  - `--embedding_file` injects a learned embedding: a torch .pt holding
    either {'emb': ..., 'emb2': ...} (XL pair), {token: tensor} (diffusers
    learned_embeds.bin), or a raw tensor. A token that is not one token of
    a tokenizer is added to it and its embedding matrix grows. Without it
    the base snapshot is assumed to already contain the token (the SD1
    reference flow).
  - `--xl` selects the SDXL path (both encoders).
Output: `{save_path}/{name}/{case_number}_{i}.png` (reference layout),
`name` the embedding file's (or else the snapshot's) name without `.pt` /
`.bin`. A row's latents are drawn from
`torch.Generator().manual_seed(evaluation_seed)`. Runs on CUDA device 0
unless `--device` says otherwise (`--device cpu` for the CPU).
"""

from __future__ import annotations

import argparse
import os
import time


def _resolve_embedding(emb_dict, token: str, key: str):
    """Pull one encoder's learned vector out of the checkpoint's dict (f32)."""
    import torch

    if isinstance(emb_dict, dict):
        if key in emb_dict:
            v = emb_dict[key]
        elif token in emb_dict:
            v = emb_dict[token]
        elif len(emb_dict) == 1:
            v = next(iter(emb_dict.values()))
        else:
            raise KeyError(
                f"cannot find {key!r} or {token!r} in embedding file keys {sorted(emb_dict)}")
    else:
        v = emb_dict
    return torch.as_tensor(v).float()


def inject_token(models, token: str, emb_path, xl: bool) -> None:
    """Write the learned embedding(s) into the loaded encoders, adding the
    token to the tokenizer(s) if it isn't a single token yet."""
    import torch

    from sliders_tpu_torch.evals.baselines import inject_learned_token, resize_token_embeddings

    emb_dict = torch.load(emb_path, map_location="cpu", weights_only=True)
    for i, te in enumerate(models.text_encoders):
        if xl or len(models.text_encoders) > 1:
            vec = _resolve_embedding(emb_dict, token, "emb" if i == 0 else "emb2")
        else:
            vec = _resolve_embedding(emb_dict, token, "emb")
        try:
            ids = te.tokenizer.tokenize(token)
        except KeyError:  # chars outside the vocab -> must be added
            ids = []
        if len(ids) != 1:
            if te.tokenizer.add_tokens(token) == 0:
                raise ValueError(f"token {token!r} is neither single nor addable")
            te.params = resize_token_embeddings(te.params, len(te.tokenizer))
            ids = [te.tokenizer.convert_tokens_to_ids(token)]
        te.params = inject_learned_token(te.params, vec, [int(ids[0])])


def main(args) -> dict:
    """Run the CLI; returns {"folder": ..., "cases": [(case, seconds), ...],
    "text_encoders": the bundles with the learned token} for in-process
    callers."""
    import torch

    from sliders_tpu_torch.cli.generate_images import (decode_batches, read_prompts_csv,
                                                       write_png)
    from sliders_tpu_torch.cli.train_text_slider import resolve_device
    from sliders_tpu_torch.diffusion import make_sampler, make_schedule
    from sliders_tpu_torch.models import loader
    from sliders_tpu_torch.pipelines import text2image as t2i
    from sliders_tpu_torch.pipelines.encoding import encode_prompts

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.precision in ("bf16", "bfloat16") else torch.float32
    if args.xl:
        models = loader.load_sdxl(args.model_name, device=device, dtype=dtype, load_vae=True)
    else:
        models = loader.load_sd(args.model_name, device=device, v2=args.v2, dtype=dtype,
                                load_vae=True)
    if args.embedding_file:
        inject_token(models, args.token, args.embedding_file, args.xl)

    sampler = make_sampler(make_schedule(), args.scheduler, args.ddim_steps)
    fn = t2i.make_sampling_fn(models.unet_config, sampler, guidance_rescale=0.0,
                              compute_dtype=dtype)

    name = os.path.basename((args.embedding_file or args.model_name).rstrip("/")).replace(
        ".pt", "").replace(".bin", "")
    folder = os.path.join(args.save_path, name)
    os.makedirs(folder, exist_ok=True)

    suffix = args.suffix.format(token=args.token)
    B = args.num_samples
    cases = []
    for case, prompt, seed in read_prompts_csv(args.prompts_path):
        if not args.from_case <= case <= args.till_case:
            continue
        prompt = f"{prompt}{suffix}"
        print(prompt, seed)
        t0 = time.perf_counter()
        if models.is_xl:
            cond, uncond, added = t2i.encode_conditioning(models, prompt, "", args.image_size)
        else:
            te = models.text_encoders[0]
            cond = encode_prompts(te.tokenizer, te.params, te.config, [prompt])
            uncond = encode_prompts(te.tokenizer, te.params, te.config, [""])
            added = None
        cond, uncond, added = t2i.tile_conditioning(cond, uncond, added, B)
        gen = torch.Generator().manual_seed(seed)
        lats = t2i.initial_latents(gen, B, args.image_size, args.image_size,
                                   sampler.init_noise_sigma)
        x = fn(models.unet_params, lats.to(device), cond, uncond, None, 0.0, -1.0,
               float(args.guidance_scale), added,
               generator=gen if sampler.stochastic else None)
        for i, img in enumerate(decode_batches(models, x, args.image_size)):
            write_png(os.path.join(folder, f"{case}_{i}.png"), img)
        cases.append((case, time.perf_counter() - t0))
    return {"folder": folder, "cases": cases, "text_encoders": models.text_encoders}


def build_parser():
    p = argparse.ArgumentParser(prog="Generate Text Inversion Images")
    p.add_argument("--model_name", required=True,
                   help="base snapshot dir (token baked in, or use --embedding_file)")
    p.add_argument("--prompts_path", required=True,
                   help="csv with case_number,prompt,evaluation_seed")
    p.add_argument("--token", required=True, help="learned token, e.g. '<sks-eyebrows>' or 'sks'")
    p.add_argument("--embedding_file", default=None,
                   help="torch .pt: {'emb','emb2'} (XL) / {token: vec} / raw tensor")
    p.add_argument("--save_path", default="images/text_inversion")
    p.add_argument("--device", default="0", help="a CUDA ordinal (default 0), cuda[:N] or cpu")
    p.add_argument("--suffix", default=" with {token}",
                   help="prompt suffix template (XL eyesize ref used ' with {token} eyes')")
    p.add_argument("--xl", action="store_true")
    p.add_argument("--v2", action="store_true")
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--num_samples", type=int, default=5)
    p.add_argument("--from_case", type=int, default=0)
    p.add_argument("--till_case", type=int, default=1000000)
    p.add_argument("--scheduler", default="ddim")
    p.add_argument("--precision", default="bfloat16")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
