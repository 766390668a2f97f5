"""Train a fleet of text sliders with the PyTorch port: one step trains every
slider (port of sliders_tpu/cli/train_fleet.py).

Where the reference trains one slider per process (train_lora.py, one run
per prompts YAML), this trains one slider per --prompts_file at once: K
adapters ride the same UNet calls as per-row stacked LoRA
(training/fleet.py).

Usage:
  python -m sliders_tpu_torch.cli.train_fleet --config_file data/config.yaml \\
      --prompts_file data/prompts-age_GPT.yaml data/prompts-smile_GPT.yaml \\
      [--names age,smile --rank 4 --alpha 1 --xl --t_to_mode stratified \\
       --resume out/..._fleet/slider_..._fleet_trainstate.pt --device 0]

Each slider saves the solo artifact set, `{name}_last.safetensors` and the
periodic `{name}_{i}steps...`, under `{save.path}/{save.name}_fleet/`
beside `{save.name}_fleet_metadata.json` and the train state
`{save.name}_fleet_trainstate.pt`. `--device` is a CUDA ordinal (the
default, 0), cuda[:N] or cpu; asking for CUDA with no CUDA device is an
error. A JAX `.msgpack` state raises, naming ROADMAP queue 1, item 15.

The dp-sharded fleet: launched as N processes (torchrun or the SLIDERS_*
variables, as `train_text_slider`), the K rows split over gcd(dp, K)
ranks (the JAX CLI's rule, printed when it differs from dp), each training
its K / dp sliders; rank 0 writes every slider's files, and the train state
is the directory `{save.name}_fleet_trainstate.dcp`, which resumes on
another dp (or a `.pt` one on a mesh). `dp: 2` on one process runs
unsharded.
"""

from __future__ import annotations

import argparse
import math

import torch.distributed as dist
from pathlib import Path

from sliders_tpu_torch.cli.train_text_slider import resolve_device, shard_unet
from sliders_tpu_torch.core import config as config_util
from sliders_tpu_torch.models import loader
from sliders_tpu_torch.ops.attention import set_attention_impl
from sliders_tpu_torch.parallel.mesh import main_rank_output, training_mesh
from sliders_tpu_torch.prompts import load_prompts_from_yaml
from sliders_tpu_torch.training.driver import load_dtype_of
from sliders_tpu_torch.training.fleet import train_fleet


def main(args, on_step=None, models=None) -> list:
    """Run the CLI; `on_step(step, state, metrics)` is passed to the driver
    and `models`, if given, are used in place of loading the snapshot (for
    in-process callers). Returns the K final LoRAs."""
    config = config_util.load_config_from_yaml(args.config_file)
    if args.name is not None:
        config.save.name = args.name
    attributes = []
    if args.attributes is not None:
        attributes = [a.strip() for a in args.attributes.split(",")]
    if args.alpha is not None:
        config.network.alpha = args.alpha
    if args.rank is not None:
        config.network.rank = args.rank
    suffix = (f"_alpha{config.network.alpha}_rank{config.network.rank}"
              f"_{config.network.training_method}")
    config.save.name += suffix
    config.save.path += f"/{config.save.name}_fleet"

    if args.names is not None:
        names = [n.strip() for n in args.names.split(",")]
        if len(names) != len(args.prompts_file):
            raise SystemExit("--names must list one name per --prompts_file")
    else:
        names = [Path(p).stem for p in args.prompts_file]
    prompt_sets = [(name + suffix, load_prompts_from_yaml(path, attributes))
                   for name, path in zip(names, args.prompts_file)]
    for name, settings in prompt_sets:
        print(f"[{name}] {len(settings)} prompt pair(s)")

    mesh, device = training_mesh(resolve_device(args.device), config.tpu.dp, config.tpu.tp,
                                 fit_dp=lambda dp, world: fleet_dp(dp, len(prompt_sets)))
    if mesh is not None and not mesh.active:
        mesh.finish()
        return []
    with main_rank_output(mesh):
        set_attention_impl(config.tpu.attention)
        if models is None:
            if args.xl:
                models = loader.load_sdxl(config.pretrained_model.name_or_path, device=device,
                                          dtype=load_dtype_of(config))
            else:
                models = loader.load_sd(config.pretrained_model.name_or_path, device=device,
                                        v2=config.pretrained_model.v2,
                                        clip_skip=config.pretrained_model.clip_skip,
                                        dtype=load_dtype_of(config))
        shard_unet(mesh, models, config.tpu.tp)
        out = train_fleet(config, prompt_sets, models, resume_from=args.resume,
                          on_step=on_step, shared_t_to=args.shared_t_to,
                          t_to_mode=args.t_to_mode, t_to_strata=args.t_to_strata, mesh=mesh)
    if mesh is not None:
        mesh.finish()
    return out


def fleet_dp(dp: int, K: int) -> int:
    """The JAX CLI's rule: the K rows split over gcd(dp, K), printed when
    it differs from dp."""
    fit = math.gcd(dp, K)
    if fit != dp and (not dist.is_initialized() or dist.get_rank() == 0):
        print(f"fleet of {K} does not divide dp={dp}; using dp={fit}")
    return fit


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_file", required=True, help="Config file for training.")
    parser.add_argument("--prompts_file", nargs="+", required=True,
                        help="One prompts YAML per slider; all sliders train at once.")
    parser.add_argument("--names", default=None,
                        help="Comma-separated slider names (default: prompts-file stems).")
    parser.add_argument("--name", default=None, help="Run-name prefix override.")
    parser.add_argument("--alpha", type=float, default=None, help="LoRA weight.")
    parser.add_argument("--rank", type=int, default=None, help="Rank of LoRA.")
    parser.add_argument("--attributes", default=None,
                        help="Attributes to disentangle (comma separated), applied to every "
                             "slider.")
    parser.add_argument("--xl", action="store_true", help="Train SDXL sliders.")
    parser.add_argument("--resume", default=None,
                        help="Train state to resume: a {name}_fleet_trainstate.pt or .dcp "
                             "written by this CLI.")
    parser.add_argument("--device", default="0",
                        help="CUDA device ordinal (as the reference), cuda[:N], or cpu.")
    parser.add_argument("--shared_t_to", action="store_true",
                        help="share row 0's per-iteration t_to draw across the fleet (the "
                             "same as --t_to_mode shared): the denoise loop runs E = (T-1)/2 "
                             "steps instead of E[max of K draws]; per-slider marginals are "
                             "unchanged.")
    parser.add_argument("--t_to_mode", default=None, choices=["per_row", "shared", "stratified"],
                        help="joint distribution of the K rows' t_to draws (marginals stay "
                             "Uniform{1..T-1} in every mode): per_row = the solo streams, "
                             "shared = row 0's draw for all, stratified = a shared coarse "
                             "stratum + independent jitter within it.")
    parser.add_argument("--t_to_strata", type=int, default=8,
                        help="stratum count S for --t_to_mode stratified.")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
