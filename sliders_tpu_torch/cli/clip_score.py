"""CLIP-score a scale-sweep run — reference eval-scripts/clip_score.py CLI
(port of sliders_tpu/cli/clip_score.py).

  python -m sliders_tpu_torch.cli.clip_score --im_path images/age_last \
      --prompt 'an old person' --prompts_path prompts.csv \
      --clip_model /path/clip-vit-base-patch32

`--im_path` is a run folder with per-scale subfolders of `{case}_{i}.png`;
scores every image against `--prompt` with CLIP ViT-B/32 and writes
`clip_scores.csv` (one column per scale). Runs on CUDA device 0 unless
`--device` says otherwise (`--device cpu` for the CPU)."""

from __future__ import annotations

import argparse


def main(args) -> dict:
    from sliders_tpu_torch.cli.train_text_slider import resolve_device
    from sliders_tpu_torch.evals.scoring import clip_scores
    from sliders_tpu_torch.models.clip_vision import load_clip_model

    params, vision_cfg, text_cfg, tokenizer = load_clip_model(args.clip_model,
                                                              resolve_device(args.device))
    return clip_scores(args.im_path, args.prompt, args.prompts_path, params, vision_cfg,
                       text_cfg, tokenizer)


def build_parser():
    p = argparse.ArgumentParser(prog="clipScore", description="Generate CLIP score for images")
    p.add_argument("--im_path", type=str, required=True)
    p.add_argument("--prompt", type=str, required=True)
    p.add_argument("--prompts_path", type=str, required=True)
    p.add_argument("--clip_model", type=str, required=True,
                   help="local snapshot of openai/clip-vit-base-patch32")
    p.add_argument("--device", default="0", help="a CUDA ordinal (default 0), cuda[:N] or cpu")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
