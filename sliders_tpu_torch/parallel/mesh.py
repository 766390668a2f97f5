"""The process mesh and the tensor-parallel split (port of
sliders_tpu/parallel/mesh.py).

One process drives one device (a rank). `make_mesh` lays the ranks out as
the JAX package lays out devices: a (dp, tp[, sp][, pp]) grid in rank
order, tp the faster of dp and tp, with one process group per axis line
through this rank. Ranks past dp * tp * sp * pp take no part in training:
the JAX package leaves surplus devices idle, and a surplus rank here waits
at the run's final barrier (`Mesh.finish`) and writes nothing.

Backends (`maybe_initialize_distributed`): NCCL when every rank of a host
has a card of its own, with gloo beside it for host tensors (the train
state's checkpoint plans); gloo when ranks share a card or run on the CPU.
Gloo takes CUDA tensors for the collectives the training steps use
(all_reduce, all_gather) by copying them through host memory itself:
`make_mesh`'s line names those ops for a gloo mesh on CUDA devices. NCCL
never stages through the host, and no path turns a CUDA run into a CPU
run.

The tp rules (`param_spec`) are the JAX package's `_TP_RULES`, the FLUX
entries included, in the JAX layout (in, out): q/k/v (FLUX's `add_*_proj`
too), the feed-forwards' `net.0.proj` and a FLUX single block's
`proj_mlp` split on their outputs, `to_out.0`, `to_add_out`, `net.2` and a
single block's `proj_out` on their inputs, everything else (resnets,
norms, convs, the adaLN modulations, the embedders, proj_in / proj_out)
replicated. `shard_params` applies them to the port's (out, in) weights
and records the split modules on the mesh (`Mesh.tp_split`), which the
UNet and the MMDiT read under `collectives.tensor_parallel`. Two FLUX
traps: its `ff.net.0.proj` is a plain GELU projection (not GEGLU's two
halves), and a single block's `proj_out` reads [attention | MLP], so its
columns split in those two parts.

A `pp` axis (`make_mesh(pp=...)`) carries the FLUX pipeline
(`parallel/pipeline.py`): its group's ranks are the stages, in order.
"""

from __future__ import annotations

import contextlib
import math
import os
import re
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist

from sliders_tpu_torch.parallel.collectives import shard_slice
from sliders_tpu_torch.utils import pytree

DATA_AXIS = "dp"
MODEL_AXIS = "tp"
SEQ_AXIS = "sp"
PIPE_AXIS = "pp"

def _env_int(*names, default: int) -> int:
    for n in names:
        if os.environ.get(n):
            return int(os.environ[n])
    return default


def world_size_from_env() -> int:
    """The process count the launcher asked for: SLIDERS_NUM_PROCESSES (the
    JAX package's variable) or torchrun's WORLD_SIZE, else 1."""
    return _env_int("SLIDERS_NUM_PROCESSES", "WORLD_SIZE", default=1)


def local_rank_from_env() -> int:
    return _env_int("LOCAL_RANK", "SLIDERS_PROCESS_ID", "RANK", default=0)


def rank_device(device: torch.device) -> torch.device:
    """This rank's device: `cuda:{LOCAL_RANK % device_count}` for a CUDA
    `device` in a multi-process run, else `device`."""
    if device.type != "cuda" or world_size_from_env() <= 1:
        return device
    return torch.device(f"cuda:{local_rank_from_env() % torch.cuda.device_count()}")


def maybe_initialize_distributed(device: Optional[torch.device] = None) -> int:
    """Join the process group before any device op when launched as several
    processes, and return the process count (1, a no-op, for a single
    process or when the group already exists with one rank).

    Reads the JAX package's variables (SLIDERS_NUM_PROCESSES,
    SLIDERS_COORDINATOR as host:port, SLIDERS_PROCESS_ID) or torchrun's
    (WORLD_SIZE, RANK, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR /
    MASTER_PORT). `device` picks the backend: NCCL (with gloo for host
    tensors) when it is CUDA and the host has a card per local rank, gloo
    otherwise."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    n = world_size_from_env()
    if n <= 1:
        return 1
    if os.environ.get("SLIDERS_NUM_PROCESSES"):
        rank = _env_int("SLIDERS_PROCESS_ID", default=0)
        init_method = f"tcp://{os.environ.get('SLIDERS_COORDINATOR', 'localhost:29500')}"
    else:
        rank = _env_int("RANK", default=0)
        init_method = (f"tcp://{os.environ.get('MASTER_ADDR', 'localhost')}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    local_world = _env_int("LOCAL_WORLD_SIZE", default=n)
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda and torch.cuda.device_count() >= local_world:
        backend = "cuda:nccl,cpu:gloo"
        torch.cuda.set_device(rank_device(torch.device("cuda")))
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=n, rank=rank)
    return n


@dataclass
class Mesh:
    """A (dp, tp[, sp][, pp]) grid of ranks: `shape` {axis: size}, this
    rank's `coords` ({} on a surplus rank), one process group per axis
    (None for a single-process mesh), the backend, the collectives that go
    through host memory, `tp_split`, the dotted module paths tp splits (set
    by `shard_params`), and `device_mesh`, the active ranks as a CPU
    `DeviceMesh` (dp, tp) for the train state's DTensors
    (`training/checkpoint.py`; None for a single-process mesh)."""

    shape: dict
    coords: dict
    groups: dict
    rank: int
    world: int
    backend: str
    via_host: tuple = ()
    tp_split: set = field(default_factory=set)
    tp_parts: dict = field(default_factory=dict)
    whole_shapes: dict = field(default_factory=dict)
    active_group: object = None
    owns_group: bool = False
    device_mesh: object = None

    @property
    def active(self) -> bool:
        return bool(self.coords)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups.get(axis)

    @property
    def is_main(self) -> bool:
        """The rank that writes files and prints (rank 0)."""
        return self.rank == 0

    def finish(self) -> None:
        """The run's final barrier over every rank, surplus ones included,
        then the process group's teardown when the mesh's caller created
        the group for it (`owns_group`; a group the process held before is
        left to its owner)."""
        if self.world > 1 and dist.is_initialized():
            dist.barrier()
            if self.owns_group:
                dist.destroy_process_group()


def mesh_shape(dp: int, tp: int, sp: int, pp: int, n: int) -> dict:
    """{axis: size} of a (dp, tp[, sp][, pp]) mesh over n ranks, with the
    JAX package's arithmetic (dp = -1: the ranks left over) and errors."""
    if dp == -1:
        if n % (tp * sp * pp) != 0:
            raise ValueError(f"{n} devices not divisible by tp*sp*pp={tp * sp * pp}")
        dp = n // (tp * sp * pp)
    if dp * tp * sp * pp > n:
        raise ValueError(f"mesh {dp}x{tp}x{sp}x{pp} needs {dp * tp * sp * pp} devices, have {n}")
    shape = {DATA_AXIS: dp, MODEL_AXIS: tp}
    if sp > 1:
        shape[SEQ_AXIS] = sp
    if pp > 1:
        shape[PIPE_AXIS] = pp
    return shape


def make_mesh(dp: int = -1, tp: int = 1, sp: int = 1, pp: int = 1,
              world: Optional[int] = None, device: Optional[torch.device] = None) -> Mesh:
    """A (dp, tp[, sp][, pp]) mesh over the process group's ranks (or
    `world` ranks without one; the JAX package's `devices`) whose tensors
    live on `device` (the CPU if None). dp = -1 takes every rank left over
    by tp * sp * pp. Raises the JAX package's errors when the ranks do not
    divide or do not suffice. Prints one line: the mesh, the world size,
    the backend, and the collectives that go through host memory (gloo's
    on CUDA tensors). Every rank must call it, in the same order."""
    initialized = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if initialized else 1
    shape = mesh_shape(dp, tp, sp, pp, world)
    dp = shape[DATA_AXIS]
    k = math.prod(shape.values())
    rank = dist.get_rank() if initialized else 0
    grid = torch.arange(k).reshape(tuple(shape.values()))
    coords = {}
    if rank < k:
        idx = (grid == rank).nonzero()[0].tolist()
        coords = dict(zip(shape, idx))
    groups: dict = {}
    backend, via_host, active_group, device_mesh = "none", (), None, None
    if initialized:
        backend = str(dist.get_backend())
        # one group per line of each axis, created by every rank in one order
        for ax_i, axis in enumerate(shape):
            lines = grid.movedim(ax_i, -1).reshape(-1, shape[axis])
            for line in lines.tolist():
                g = dist.new_group(line)
                if rank in line:
                    groups[axis] = g
        active_group = dist.new_group(list(range(k)))
        if backend == "gloo" and device is not None and torch.device(device).type == "cuda":
            # gloo copies these itself; send / recv are staged by
            # `collectives.isend_tensors` / `irecv_tensors`
            via_host = ("all_reduce", "all_gather") + (("send/recv",) if pp > 1 else ())
        if "nccl" in backend:
            backend = "nccl"
        if sp == pp == 1:
            from torch.distributed.device_mesh import DeviceMesh

            device_mesh = DeviceMesh("cpu", grid, mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    mesh = Mesh(shape=shape, coords=coords, groups=groups, rank=rank, world=world,
                backend=backend, via_host=via_host, active_group=active_group,
                device_mesh=device_mesh)
    if mesh.is_main:
        axes = " x ".join(f"{a}={s}" for a, s in shape.items())
        share = ""
        if backend == "gloo" and torch.cuda.is_available() and world > torch.cuda.device_count():
            share = f" ({world} ranks share {torch.cuda.device_count()} card(s))"
        surplus = f", {world - k} surplus rank(s) idle" if world > k else ""
        print(f"mesh {axes}: world {world}, backend {backend}{share}{surplus}; collectives "
              f"through host memory: {', '.join(via_host) or 'none'}", flush=True)
    return mesh


# --- tensor-parallel rules (the JAX package's `_TP_RULES`) -------------------
#
# Each spec is in the JAX layout (in, out) of a linear weight; `shard_params`
# maps it onto the port's (out, in) layout.

_TP_RULES: list = [
    (r"to_[qkv]\.weight$", (None, MODEL_AXIS)),
    (r"to_[qkv]\.bias$", (MODEL_AXIS,)),
    (r"add_[qkv]_proj\.weight$", (None, MODEL_AXIS)),
    (r"add_[qkv]_proj\.bias$", (MODEL_AXIS,)),
    (r"to_out\.0\.weight$", (MODEL_AXIS, None)),
    (r"to_add_out\.weight$", (MODEL_AXIS, None)),
    (r"ff\.net\.0\.proj\.weight$", (None, MODEL_AXIS)),
    (r"ff\.net\.0\.proj\.bias$", (MODEL_AXIS,)),
    (r"ff\.net\.2\.weight$", (MODEL_AXIS, None)),
    (r"ff_context\.net\.0\.proj\.weight$", (None, MODEL_AXIS)),
    (r"ff_context\.net\.0\.proj\.bias$", (MODEL_AXIS,)),
    (r"ff_context\.net\.2\.weight$", (MODEL_AXIS, None)),
    (r"single_transformer_blocks\.\d+\.proj_mlp\.weight$", (None, MODEL_AXIS)),
    (r"single_transformer_blocks\.\d+\.proj_mlp\.bias$", (MODEL_AXIS,)),
    (r"single_transformer_blocks\.\d+\.proj_out\.weight$", (MODEL_AXIS, None)),
]
_TP_COMPILED = [(re.compile(p), axes) for p, axes in _TP_RULES]


def param_spec(path: str, tp_enabled: bool, ndim: Optional[int] = None) -> tuple:
    """The JAX-layout partition spec of the parameter at dotted `path`: a
    tuple of axis names or None per dimension, () when replicated. A spec
    longer than `ndim` (the leaf's rank, e.g. a conv's bias) is replicated,
    as the JAX package's `shard_params` drops it."""
    if tp_enabled:
        for pat, axes in _TP_COMPILED:
            if pat.search(path):
                if ndim is not None and len(axes) > ndim:
                    return ()
                return axes
    return ()


# The units tp splits together, each with the head count `heads` keys it
# by: a UNet attention (`...attn1` / `attn2`), a FLUX double block's joint
# attention (`transformer_blocks.N.attn`: both streams' q/k/v and their two
# out projections), a FLUX single block (`single_transformer_blocks.N`: its
# q/k/v, `proj_mlp` and the `proj_out` that reads both), and a
# feed-forward (`...ff`, FLUX's `ff_context` too). FLUX's paths start at
# the transformer's root, the UNet's under its blocks.
_UNITS = (
    re.compile(r"^(single_transformer_blocks\.\d+)\.(?:attn\.to_[qkv]|proj_mlp|proj_out)\."
               r"(?:weight|bias)$"),
    re.compile(r"^(transformer_blocks\.\d+\.attn)\.(?:to_[qkv]|add_[qkv]_proj|to_out\.0|"
               r"to_add_out)\.(?:weight|bias)$"),
    re.compile(r"^(.*\.attn[12])\.(?:to_q|to_k|to_v|to_out\.0)\.(?:weight|bias)$"),
    re.compile(r"^(.*\.ff(?:_context)?)\.net\.(?:0\.proj|2)\.(?:weight|bias)$"),
)


def _tp_unit(path: str) -> Optional[str]:
    for pat in _UNITS:
        m = pat.match(path)
        if m is not None:
            return m.group(1)
    return None


def _split_parts(path: str, n: int, dim: int, unit: str, geglu, flat: dict) -> tuple:
    """The widths of the blocks that a split dimension of size n is made
    of. A GEGLU feed-forward's `net.0.proj` (a unit in `geglu`: the
    UNet's) outputs [h | gate], two halves; FLUX's MLP projection is a
    plain tanh-GELU one, split contiguously. A FLUX single block's
    `proj_out` reads [attention | MLP], whose MLP part is as wide as
    `proj_mlp`'s output."""
    if unit in geglu and path.startswith(f"{unit}.net.0.proj."):
        return (n // 2, n // 2)
    if path == f"{unit}.proj_out.weight" and dim == 1:
        mlp = flat[f"{unit}.proj_mlp.weight"].shape[0]
        return (n - mlp, mlp)
    return (n,)


def shard_params(mesh: Mesh, params: dict, tp_enabled: bool = False,
                 heads: Optional[dict] = None, geglu=(), prefix: str = "") -> dict:
    """This rank's slices of a UNet or FLUX parameter tree under
    `param_spec`: an output-split weight keeps rows (out) r of tp, an
    input-split one columns (in) r of tp, a split bias its slice, each of
    the blocks a split dimension is made of split on its own
    (`_split_parts`: the two halves of a GEGLU unit in `geglu`,
    `models.unet2d.geglu_units`; a FLUX single block's `proj_out`
    columns [attention slice r | MLP slice r], so that its one all-reduce
    sums the products of this rank's own heads and MLP rows). A unit
    (`_UNITS`) whose head count (`heads`, {unit: heads};
    `models.unet2d.attention_heads`, or a FLUX block's from `tp_keep`)
    tp does not divide, or one with a width it does not divide, stays whole on
    every rank with no collective (printed once). Records the split
    modules and their parts on the mesh (`Mesh.tp_split`, `tp_parts`) and
    the split leaves' whole shapes (`whole_shapes`); a call on a subtree
    at dotted `prefix` (a FLUX block as `flux.init_params` draws it) adds
    to them. Returns a new tree sharing the unsplit leaves."""
    tp = mesh.size(MODEL_AXIS)
    if not tp_enabled or tp == 1:
        return params
    root = f"{prefix}." if prefix else ""
    flat = {root + p: t for p, t in pytree.flatten(params).items()}
    r = mesh.coord(MODEL_AXIS)
    plan = {}  # path -> (unit, dim, parts)
    for path, leaf in flat.items():
        spec = param_spec(path, True, leaf.ndim)
        if not spec:
            continue
        unit = _tp_unit(path)
        if unit is None:
            raise NotImplementedError(f"{path}: a tp rule matches a module of no known block "
                                      "(ROADMAP queue 1, item 15)")
        # the JAX spec is (in, out); the port's weight is (out, in)
        dim = (1 if spec[0] == MODEL_AXIS else 0) if leaf.ndim == 2 else 0
        plan[path] = (unit, dim, _split_parts(path, leaf.shape[dim], dim, unit, geglu, flat))
    kept_whole = {u for u, h in (heads or {}).items() if h % tp}
    kept_whole |= {u for u, _, parts in plan.values() if any(w % tp for w in parts)}
    out = dict(flat)
    for path, (unit, dim, parts) in plan.items():
        if unit in kept_whole:
            continue
        leaf = flat[path]
        out[path] = shard_slice(leaf, dim, r, tp, parts=parts).contiguous()
        mesh.whole_shapes[path] = tuple(leaf.shape)
        module = path.rsplit(".", 1)[0]
        mesh.tp_split.add(module)
        if len(parts) > 1:
            mesh.tp_parts[module] = parts
    kept = sorted(u for u in kept_whole if any(p[0] == u for p in plan.values()))
    if kept and mesh.is_main:
        print(f"tp={tp}: {len(kept)} block(s) whose heads or width tp does not divide "
              f"stay whole on every rank, e.g. {kept[0]}", flush=True)
    return pytree.unflatten({p[len(root):]: t for p, t in out.items()})


def tp_keep(mesh: Mesh, tp_enabled: bool = True):
    """The `keep` hook of `models.flux.init_params` / `keep_blocks` that
    replaces each FLUX block by this rank's tp shard (`shard_params`, with
    the block's head count read from its q projection and q norm; FLUX has
    no GEGLU unit)."""

    def keep(prefix, block):
        a = block["attn"]
        heads = a["to_q"]["weight"].shape[0] // a["norm_q"]["weight"].shape[0]
        unit = f"{prefix}.attn" if prefix.startswith("transformer_blocks") else prefix
        return shard_params(mesh, block, tp_enabled=tp_enabled, heads={unit: heads},
                            prefix=prefix)

    return keep


def whole_params(mesh: Optional[Mesh], params: dict) -> dict:
    """`params` with every leaf `shard_params` split replaced by a meta
    tensor of its whole shape: the tree a LoRA is sized and drawn from, so
    that every rank draws the world-1 run's factors."""
    if mesh is None or not mesh.whole_shapes:
        return params
    flat = pytree.flatten(params)
    return pytree.unflatten({p: torch.empty(mesh.whole_shapes[p], dtype=t.dtype, device="meta")
                             if p in mesh.whole_shapes else t for p, t in flat.items()})


def training_mesh(device: torch.device, dp: int, tp: int, fit_dp=None) -> tuple:
    """The training CLIs' mesh, under the JAX CLIs' condition: joins the
    process group (`maybe_initialize_distributed`), then builds a mesh when
    there is more than one process or tp > 1 (so `dp: 2` on one process
    runs unsharded and `tp: 2` raises `make_mesh`'s error). `fit_dp(dp,
    world)`, if given, turns the asked dp (-1 resolved) into the one the
    CLI runs. Returns (mesh or None, this rank's device); the mesh owns
    the process group (`Mesh.finish` tears it down) when this call joined
    it."""
    created = not (dist.is_available() and dist.is_initialized())
    world = maybe_initialize_distributed(device)
    device = rank_device(device)
    if world == 1 and tp == 1:
        return None, device
    if fit_dp is not None:
        dp = fit_dp(mesh_shape(dp, tp, 1, 1, world)[DATA_AXIS], world)
    mesh = make_mesh(dp=dp, tp=tp, device=device)
    mesh.owns_group = created
    return mesh, device


@contextlib.contextmanager
def main_rank_output(mesh: Optional[Mesh]):
    """Inside the block, the standard output of every rank but the main one
    is discarded: one copy of the CLI's lines."""
    if mesh is None or mesh.is_main:
        yield
        return
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        yield
