"""LPIPS-score a scale-sweep run vs its scale-0 folder — reference
eval-scripts/lpip_score.py CLI (port of sliders_tpu/cli/lpips_score.py).

  python -m sliders_tpu_torch.cli.lpips_score --im_path images/age_last \
      --prompts_path prompts.csv --true 0 \
      --alexnet_weights alexnet.pth --lpips_weights alex.pth

Writes `lpips_score.csv` (one column per scale but `--true`). Runs on CUDA
device 0 unless `--device` says otherwise (`--device cpu` for the CPU)."""

from __future__ import annotations

import argparse


def main(args) -> dict:
    from sliders_tpu_torch.cli.train_text_slider import resolve_device
    from sliders_tpu_torch.evals.lpips import load_torch_weights
    from sliders_tpu_torch.evals.scoring import lpips_scores

    params = load_torch_weights(args.alexnet_weights, args.lpips_weights,
                                resolve_device(args.device))
    return lpips_scores(args.im_path, args.true, args.prompts_path, params)


def build_parser():
    p = argparse.ArgumentParser(prog="LPIPS")
    p.add_argument("--im_path", type=str, required=True)
    p.add_argument("--prompts_path", type=str, required=True)
    p.add_argument("--true", type=str, required=True, help="scale-0 folder name")
    p.add_argument("--alexnet_weights", type=str, required=True,
                   help="local torchvision alexnet state_dict (.pth)")
    p.add_argument("--lpips_weights", type=str, required=True,
                   help="local lpips 'alex.pth' linear weights")
    p.add_argument("--device", default="0", help="a CUDA ordinal (default 0), cuda[:N] or cpu")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
