"""Train a FLUX text slider (flow matching) with the PyTorch port (port of
sliders_tpu/cli/train_flux_slider.py): the JAX CLI's flags, run-name
mangling `_alpha{a}_rank{r}_{method}`, stdout lines and saved files, with an
ortho-up LoRA (frozen orthogonal up) for every method but 'full'.

Usage:
  python -m sliders_tpu_torch.cli.train_flux_slider --config_file data/config.yaml \\
      [--prompts_file ... --rank 16 --alpha 1 --name age_flux --device 0]

`--device` is a CUDA device ordinal (default 0), `cuda[:N]`, or `cpu` (the
tests); asking for CUDA with no CUDA device is an error. The loop itself is
`training.driver.train_flux_sliders`, which takes loaded models, so a caller
that already holds them (chip_smoke.py) trains without a snapshot on disk.

Mesh runs (`tpu.dp`, `tpu.tp`; `parallel/mesh.py`), as the JAX CLI builds
them: launch N processes with torchrun or the SLIDERS_* variables,

  torchrun --nproc-per-node 2 -m sliders_tpu_torch.cli.train_flux_slider \
      --config_file cfg.yaml        # tpu: {dp: 1, tp: 2}

A mesh is built when there is more than one process or tp > 1; when the
prompts' `batch_size` is not a multiple of dp, dp falls back to 1 at the
same tp (the JAX CLI's rule). Each rank loads the transformer, keeps its tp
shard, and draws the whole LoRA; only rank 0 prints and writes.
"""

from __future__ import annotations

import argparse

from sliders_tpu_torch.cli.train_text_slider import resolve_device
from sliders_tpu_torch.core import config as config_util
from sliders_tpu_torch.models import loader
from sliders_tpu_torch.ops.attention import set_attention_impl
from sliders_tpu_torch.parallel.mesh import main_rank_output, tp_keep, training_mesh
from sliders_tpu_torch.prompts import load_prompts_from_yaml
from sliders_tpu_torch.training.driver import load_dtype_of, train_flux_sliders


def main(args, on_step=None, lora=None):
    """Run the CLI; `on_step(step, state, metrics)` and `lora` (a tree to
    train from) are passed to the driver, for in-process callers. Returns
    the final LoRA weights."""
    config = config_util.load_config_from_yaml(args.config_file)
    if args.name is not None:
        config.save.name = args.name
    if args.prompts_file is not None:
        config.prompts_file = args.prompts_file
    if args.rank is not None:
        config.network.rank = args.rank
    if args.alpha is not None:
        config.network.alpha = args.alpha
    config.save.name += f"_alpha{config.network.alpha}"
    config.save.name += f"_rank{config.network.rank}"
    config.save.name += f"_{config.network.training_method}"
    config.save.path += f"/{config.save.name}"

    attributes = []
    if args.attributes is not None:
        attributes = [a.strip() for a in args.attributes.split(",")]
    prompts = load_prompts_from_yaml(config.prompts_file, attributes)

    batch = prompts[0].batch_size
    mesh, device = training_mesh(resolve_device(args.device), config.tpu.dp, config.tpu.tp,
                                 fit_dp=lambda dp, world: dp if batch % dp == 0 else 1)
    if mesh is not None and not mesh.active:
        mesh.finish()
        return None
    with main_rank_output(mesh):
        set_attention_impl(config.tpu.attention)
        models = loader.load_flux(config.pretrained_model.name_or_path, device=device,
                                  dtype=load_dtype_of(config),
                                  transformer_keep=None if mesh is None else tp_keep(
                                      mesh, config.tpu.tp > 1))
        out = train_flux_sliders(config, prompts, models, seed=args.seed, t5_len=args.t5_len,
                                 transformer_guidance=args.transformer_guidance,
                                 on_step=on_step, lora=lora, mesh=mesh)
    if mesh is not None:
        mesh.finish()
    return out


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--config_file", required=True)
    p.add_argument("--prompts_file", default=None)
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--alpha", type=float, default=None)
    p.add_argument("--name", type=str, default=None)
    p.add_argument("--attributes", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--t5_len", type=int, default=512)
    p.add_argument(
        "--transformer_guidance", type=float, default=1.0,
        help="guidance-embedding value during training (FLUX.1-dev)",
    )
    p.add_argument("--device", default="0",
                   help="CUDA device ordinal (as the reference), cuda[:N], or cpu.")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
