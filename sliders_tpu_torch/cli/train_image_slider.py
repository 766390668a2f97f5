"""Train an image slider from paired before/after folders with the PyTorch
port (port of sliders_tpu/cli/train_image_slider.py): the reference's flags
(train_lora-scale.py:376-501 / train_lora-scale-xl.py), the same run-name
mangling `_alpha{a}_rank{r}_{method}`, the same config and prompt YAMLs.

Usage:
  python -m sliders_tpu_torch.cli.train_image_slider --config_file data/config.yaml \\
      --folder_main path/to/pairs --folders 'bigsize, smallsize' --scales '1, -1' \\
      [--name ... --rank 4 --alpha 1 --resolution 256 --xl --stylecheck 1 --device 0]

Training resolution follows the reference scripts: 256 px for SD1, 512 for
SDXL (`--xl`, which loads an SDXL snapshot). `--stylecheck` trains one
slider per sorted sub-folder of `--folder_main`, one after another, each
saved as `{style}_{name}`; with `--fleet`, every style's slider trains in
one step (`training/fleet.train_fleet_images`), saved under the same names.
`--fleet` without `--stylecheck` exits. `--device` is a CUDA ordinal (the
default, 0), cuda[:N] or cpu; asking for CUDA with no CUDA device is an
error. `--prompts_file` is parsed and not applied, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import os

from sliders_tpu_torch.cli.train_text_slider import resolve_device
from sliders_tpu_torch.core import config as config_util
from sliders_tpu_torch.data.paired_images import parse_folder_args
from sliders_tpu_torch.models import loader
from sliders_tpu_torch.ops.attention import set_attention_impl
from sliders_tpu_torch.prompts import load_prompts_from_yaml
from sliders_tpu_torch.training.driver import compute_dtype_of, train_image_sliders
from sliders_tpu_torch.training.fleet import train_fleet_images


def main(args, on_step=None) -> dict:
    """Run the CLI; `on_step(step, state, metrics)` is passed to the driver
    (for in-process callers). Returns {save name: final LoRA} for each
    slider trained."""
    if args.fleet and args.stylecheck is None:
        raise SystemExit("--fleet needs --stylecheck (one slider per style folder)")
    config = config_util.load_config_from_yaml(args.config_file)
    if args.name is not None:
        config.save.name = args.name
    attributes = []
    if args.attributes is not None:
        attributes = [a.strip() for a in args.attributes.split(",")]
    if args.rank is not None:
        config.network.rank = args.rank
    if args.alpha is not None:
        config.network.alpha = args.alpha
    config.save.name += f"_alpha{config.network.alpha}"
    config.save.name += f"_rank{config.network.rank}"
    config.save.name += f"_{config.network.training_method}"
    config.save.path += f"/{config.save.name}"

    device = resolve_device(args.device)
    set_attention_impl(config.tpu.attention)
    dtype = compute_dtype_of(config)
    if args.xl:
        models = loader.load_sdxl(config.pretrained_model.name_or_path, device=device,
                                  dtype=dtype, load_vae=True)
        resolution = args.resolution or 512
    else:
        models = loader.load_sd(config.pretrained_model.name_or_path, device=device,
                                v2=config.pretrained_model.v2,
                                clip_skip=config.pretrained_model.clip_skip, dtype=dtype,
                                load_vae=True)
        resolution = args.resolution or 256

    prompts = load_prompts_from_yaml(config.prompts_file, attributes)
    folders, scales = parse_folder_args(args.folders, args.scales)
    runs = [(config.save.name, args.folder_main)]
    if args.stylecheck is not None:
        # the reference's --stylecheck: one slider per style folder
        # (train_lora-scale.py:408-417)
        base_name, base_main = config.save.name, args.folder_main
        runs = [(f"{style}_{base_name}", os.path.join(base_main, style))
                for style in sorted(os.listdir(base_main))]
    if args.fleet:
        # every style's slider in one step
        loras = train_fleet_images(config, prompts, models, runs, folders, scales, resolution,
                                   on_step=on_step)
        return {name: lora for (name, _), lora in zip(runs, loras)}
    out = {}
    for name, folder_main in runs:
        config.save.name = name
        out[name] = train_image_sliders(config, prompts, models, folder_main, folders, scales,
                                        resolution, on_step=on_step)
    return out


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--config_file", required=True, help="Config file for training.")
    # parsed and not applied, as in the JAX CLI: training reads the
    # config's prompts_file
    p.add_argument("--prompts_file", default=None, help="Prompts file for training.")
    p.add_argument("--alpha", type=float, default=None, help="LoRA weight.")
    p.add_argument("--rank", type=int, default=None, help="Rank of LoRA.")
    p.add_argument("--device", default="0",
                   help="CUDA device ordinal (as the reference), cuda[:N], or cpu.")
    p.add_argument("--name", type=str, default=None, help="Run name.")
    p.add_argument("--attributes", type=str, default=None,
                   help="attributes to disentangle (comma separated string)")
    p.add_argument("--folder_main", type=str, required=True,
                   help="Folder holding one sub-folder per scale.")
    p.add_argument("--folders", type=str, default="verylow, low, high, veryhigh",
                   help="Scale folders (comma separated), aligned with --scales.")
    p.add_argument("--scales", type=str, default="-2, -1, 1, 2",
                   help="Slider scale of each folder (comma separated).")
    p.add_argument("--stylecheck", type=str, default=None,
                   help="Train one slider per sorted style folder under --folder_main.")
    p.add_argument("--fleet", action="store_true",
                   help="With --stylecheck, every style's slider in one step.")
    p.add_argument("--resolution", type=int, default=None,
                   help="Train resolution (default 256, 512 with --xl).")
    p.add_argument("--xl", action="store_true", help="Train on SDXL.")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
