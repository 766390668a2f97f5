"""Sharded train states over a process mesh (port of
sliders_tpu/training/checkpoint.py) on `torch.distributed.checkpoint`.

A mesh run writes its state to `{name}_trainstate.dcp/<step>/` (the JAX
package writes `{name}_trainstate.orbax/<step>/`), with JAX's commit
protocol: every rank writes into `<step>.tmp/`, a barrier, rank 0 renames
it to `<step>/`, and only then are the steps past the newest two pruned,
so a save killed halfway leaves the last good state, and a leftover
`.tmp` is ignored on resume.

Leaves: the replicated ones (a text or image slider's LoRA and optimizer
state, the step, the seed) are plain tensors, which DCP's planner writes
once; a fleet's row-sharded leaves (every adapter and per-leaf optimizer
tensor, whose leading axis is the fleet's rows) are DTensors sharded on
dim 0 over the dp axis of `Mesh.device_mesh`, so a restore onto another
dp, or at world 1 with no process group, reshards them. The step, the seed
and the optimizer's count are 0-d int64 tensors in the file and Python
ints again after the restore; every float leaf round-trips bit for bit.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import warnings
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from sliders_tpu_torch.utils import pytree

KEEP = 2


def _flat(state) -> dict:
    """The state's leaves by '/'-joined path (module paths hold dots)."""
    return pytree.flatten({"step": state.step, "seed": state.seed, "lora": state.lora,
                           "opt_state": state.opt_state}, sep="/")


def _row_sharded(path: str, leaf) -> bool:
    """A fleet leaf with the rows' leading axis: every adapter and
    optimizer tensor but the 0-d scalars."""
    return path.startswith(("lora/", "opt_state/")) and isinstance(leaf, torch.Tensor) \
        and leaf.ndim > 0


def _to_saved(flat: dict, mesh, row_sharded: bool) -> dict:
    """CPU tensors (ints as 0-d int64), a fleet's row leaves as DTensors."""
    out = {}
    for path, leaf in flat.items():
        if isinstance(leaf, bool) or not isinstance(leaf, (int, float, torch.Tensor)):
            raise TypeError(f"{path}: cannot checkpoint a {type(leaf).__name__}")
        if not isinstance(leaf, torch.Tensor):
            leaf = torch.tensor(leaf, dtype=torch.int64 if isinstance(leaf, int)
                                else torch.float64)
        t = leaf.detach().cpu()
        if row_sharded and _row_sharded(path, leaf) and _dp_mesh(mesh) is not None:
            from torch.distributed.tensor import DTensor, Replicate, Shard

            t = DTensor.from_local(t.contiguous(), _dp_mesh(mesh), [Shard(0), Replicate()],
                                   run_check=False)
        out[path] = t
    return out


def _dp_mesh(mesh):
    return None if mesh is None else mesh.device_mesh


def _steps(directory: Path) -> list:
    if not directory.is_dir():
        return []
    return sorted(int(p.name) for p in directory.iterdir() if p.is_dir() and p.name.isdigit())


def latest_step(directory: str) -> Optional[int]:
    """The newest committed step under `directory` (a `.tmp` is not one)."""
    steps = _steps(Path(directory))
    return steps[-1] if steps else None


def is_dcp_state(path: str) -> bool:
    """A directory of committed steps that each hold DCP's `.metadata`."""
    p = Path(path)
    steps = _steps(p)
    return bool(steps) and (p / str(steps[-1]) / ".metadata").is_file()


def save_sharded(directory: str, state, mesh=None, row_sharded: bool = False) -> None:
    """Write `state` (a `SliderTrainState`) as `directory/<state.step>/`,
    committed by rename, keeping the newest `KEEP` steps. Every active rank
    of `mesh` calls it (no process group at world 1); `row_sharded` marks a
    fleet state whose leaves hold this rank's rows."""
    import torch.distributed.checkpoint as dcp

    root = Path(directory)
    step = int(state.step)
    tmp = root / f"{step}.tmp"
    main = mesh is None or mesh.is_main
    group = None if mesh is None else mesh.active_group
    if main:
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
    _barrier(group)
    saved = _to_saved(_flat(state), mesh, row_sharded)
    with _single_process_quiet():
        dcp.save(saved, checkpoint_id=str(tmp), process_group=group, no_dist=group is None)
    _barrier(group)
    if main:
        final = root / str(step)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in _steps(root)[:-KEEP]:
            shutil.rmtree(root / str(old), ignore_errors=True)
    _barrier(group)


def restore_sharded(directory: str, template, mesh=None, row_sharded: bool = False):
    """The newest committed step under `directory`, read onto `template`'s
    layout (a fresh `SliderTrainState` of the resuming run, whose fleet
    rows, with `row_sharded`, are this rank's share) and returned as a new
    state on the template's device. The saving mesh may differ."""
    import torch.distributed.checkpoint as dcp

    step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no committed train-state steps under {directory}")
    flat = _flat(template)
    target = _to_saved(flat, mesh, row_sharded)
    group = None if mesh is None else mesh.active_group
    with _single_process_quiet():
        dcp.load(target, checkpoint_id=str(Path(directory) / str(step)), process_group=group,
                 no_dist=group is None)
    restored = {}
    for path, leaf in flat.items():
        t = target[path]
        if hasattr(t, "to_local"):
            t = t.to_local()
        if isinstance(leaf, torch.Tensor):
            restored[path] = t.to(device=leaf.device, dtype=leaf.dtype)
        else:
            restored[path] = type(leaf)(t.item())
    tree = pytree.unflatten(restored, sep="/")
    return type(template)(step=tree["step"], seed=tree["seed"], lora=tree["lora"],
                          opt_state=tree["opt_state"])


@contextlib.contextmanager
def _single_process_quiet():
    """DCP warns that it assumes a single process whenever no process group
    exists, which is what a world-1 save or restore asks for."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        yield


def _barrier(group) -> None:
    if group is not None:
        dist.barrier(group=group)
