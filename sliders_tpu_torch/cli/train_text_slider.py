"""Train an SD1.x or SDXL text slider with the PyTorch port (port of
sliders_tpu/cli/train_text_slider.py): the reference trainer's flags
(train_lora.py:371-429), the same run-name mangling
`_alpha{a}_rank{r}_{method}` (train_lora.py:360-363), the same config and
prompt YAMLs.

Usage:
  python -m sliders_tpu_torch.cli.train_text_slider --config_file data/config.yaml \\
      [--prompts_file ... --rank 4 --alpha 1 --name age_slider \\
       --attributes 'male, female' --device 0 --resume path_trainstate.pt]

`--device` keeps the reference's meaning, a CUDA device ordinal (`cuda:N`);
`cpu` runs on the CPU (tests). Asking for CUDA with no CUDA device is an
error. `--xl` loads an SDXL snapshot (`loader.load_sdxl`), as in the JAX CLI.

Mesh runs (`tpu.dp`, `tpu.tp`; `parallel/mesh.py`): launch N processes with
`python -m torch.distributed.run --nproc_per_node N -m
sliders_tpu_torch.cli.train_text_slider ...` or with the JAX package's
variables SLIDERS_NUM_PROCESSES / SLIDERS_COORDINATOR / SLIDERS_PROCESS_ID.
A mesh is built when there is more than one process or tp > 1, so `dp: 2`
on one process runs unsharded and `tp: 2` on one raises. Each rank runs on
`cuda:{LOCAL_RANK % device_count}` (NCCL with a card a rank, gloo when
ranks share one) or, with `--device cpu`, on the CPU over gloo; only rank 0
prints and writes. The train state of a mesh run is the directory
`{name}_trainstate.dcp`, and `--resume` takes it or a `.pt` at any world
size.
"""

from __future__ import annotations

import argparse

import torch

from sliders_tpu_torch.core import config as config_util
from sliders_tpu_torch.models import loader, unet2d
from sliders_tpu_torch.ops.attention import set_attention_impl
from sliders_tpu_torch.parallel.mesh import main_rank_output, shard_params, training_mesh
from sliders_tpu_torch.prompts import load_prompts_from_yaml
from sliders_tpu_torch.training.driver import load_dtype_of, train_text_sliders


def resolve_device(spec: str) -> torch.device:
    """'cpu', a CUDA ordinal ('0' -> cuda:0) or 'cuda[:N]'."""
    spec = str(spec).strip()
    if spec == "cpu":
        return torch.device("cpu")
    device = torch.device(f"cuda:{spec}" if spec.isdigit() else spec)
    if device.type != "cuda":
        raise ValueError(f"--device takes a CUDA ordinal, cuda[:N] or cpu, not {spec!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"--device {spec} asks for a CUDA device, but none is available "
                           "(pass --device cpu to train on the CPU)")
    if (device.index or 0) >= torch.cuda.device_count():
        raise RuntimeError(f"--device {spec}: only {torch.cuda.device_count()} CUDA device(s)")
    return device


def main(args, on_step=None):
    """Run the CLI; `on_step(step, state, metrics)` is passed to the driver
    (for in-process callers). Returns the final LoRA weights."""
    config = config_util.load_config_from_yaml(args.config_file)
    if args.name is not None:
        config.save.name = args.name
    attributes = []
    if args.attributes is not None:
        attributes = [a.strip() for a in args.attributes.split(",")]
    if args.prompts_file is not None:
        config.prompts_file = args.prompts_file
    if args.alpha is not None:
        config.network.alpha = args.alpha
    if args.rank is not None:
        config.network.rank = args.rank
    config.save.name += f"_alpha{config.network.alpha}"
    config.save.name += f"_rank{config.network.rank}"
    config.save.name += f"_{config.network.training_method}"
    config.save.path += f"/{config.save.name}"

    prompts = load_prompts_from_yaml(config.prompts_file, attributes)
    mesh, device = training_mesh(resolve_device(args.device), config.tpu.dp, config.tpu.tp)
    if mesh is not None and not mesh.active:
        mesh.finish()
        return None
    with main_rank_output(mesh):
        for p in prompts:
            print(p)
        set_attention_impl(config.tpu.attention)
        if args.xl:
            models = loader.load_sdxl(config.pretrained_model.name_or_path, device=device,
                                      dtype=load_dtype_of(config))
        else:
            models = loader.load_sd(
                config.pretrained_model.name_or_path,
                device=device,
                v2=config.pretrained_model.v2,
                clip_skip=config.pretrained_model.clip_skip,
                dtype=load_dtype_of(config),
            )
        shard_unet(mesh, models, config.tpu.tp)
        out = train_text_sliders(config, prompts, models, resume_from=args.resume,
                                 on_step=on_step, mesh=mesh)
    if mesh is not None:
        mesh.finish()
    return out


def shard_unet(mesh, models, tp: int) -> None:
    """The UNet's parameters replaced by this rank's tp shards
    (`shard_params` with tp_enabled = tp > 1), as the JAX CLIs shard them."""
    if mesh is not None:
        models.unet_params = shard_params(mesh, models.unet_params, tp_enabled=tp > 1,
                                          heads=unet2d.attention_heads(models.unet_config),
                                          geglu=unet2d.geglu_units(models.unet_config))


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_file", required=True, help="Config file for training.")
    parser.add_argument("--prompts_file", default=None, help="Prompts file for training.")
    parser.add_argument("--alpha", type=float, default=None, help="LoRA weight.")
    parser.add_argument("--rank", type=int, default=None, help="Rank of LoRA.")
    parser.add_argument("--device", default="0",
                        help="CUDA device ordinal (as the reference), cuda[:N], or cpu.")
    parser.add_argument("--name", type=str, default=None, help="Run name.")
    parser.add_argument(
        "--attributes", type=str, default=None,
        help="attributes to disentangle (comma separated string)",
    )
    parser.add_argument("--xl", action="store_true", help="Train on SDXL.")
    parser.add_argument("--resume", type=str, default=None,
                        help="Train state to resume: a {name}_trainstate.pt or "
                             "{name}_trainstate.dcp written by this CLI.")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
