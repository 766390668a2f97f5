"""Autograd-aware collectives over the axes of a `parallel.mesh.Mesh`.

In the JAX package XLA inserts these from the shardings; here they are
explicit:

- Megatron's pair for tensor parallelism (tp): `copy_to_tp` (identity
  forward, all-reduce backward) in front of a column-parallel linear and
  `reduce_from_tp` (all-reduce forward, identity backward) after a
  row-parallel one, so each attention or feed-forward block costs one
  all-reduce forward and one backward;
- `gather_rows` / `scatter_rows` over the data axis (dp) for the row
  fan-outs of the training steps, which need not divide: 3 frozen rows
  over dp = 2 give ranks 2 and 1 rows (`row_range`);
- `all_reduce_grads`: the LoRA gradient summed over tp for the modules
  whose base weight tp splits, then averaged over dp;
- `isend_tensors` / `irecv_tensors` between the stages of the pipeline
  axis (pp, `parallel/pipeline.py`), staged through host buffers when the
  ranks share a card over gloo.

`tensor_parallel(mesh)` makes a mesh's tp split visible to the UNet's
attention and feed-forward blocks (`tp_shard`); outside it, or on a mesh
whose tp is 1, the blocks run whole. Every collective is a no-op on an axis
of size 1 without a process group.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class TPShard:
    """This rank's share of a tp-split linear: `mode` 'col' (output
    features split) or 'row' (input features split), shard `index` of
    `size`, the mesh whose tp group reduces it, and `parts`, the widths of
    the blocks the split features are made of, each split on its own (()
    for one block; GEGLU's [h | gate] output is two equal halves, a FLUX
    single block's `proj_out` input [attention | MLP] two unequal parts)."""

    mode: str
    index: int
    size: int
    mesh: object
    parts: tuple = ()


def shard_slice(t: torch.Tensor, dim: int, index: int, size: int,
                parts: tuple = ()) -> torch.Tensor:
    """Shard `index` of `size` along `dim`: the `index`-th slice of each
    block of `parts` (widths summing to the dim's size; () for one block),
    concatenated. GEGLU's projection chunks its output into [h | gate], so
    rank r holds the r-th slice of h and of gate; a FLUX single block's
    `proj_out` reads [attention | MLP], so rank r holds the columns of its
    own heads and of its own MLP rows."""
    out, start = [], 0
    for w in parts or (t.shape[dim],):
        width = w // size
        out.append(t.narrow(dim, start + index * width, width))
        start += w
    return out[0] if len(out) == 1 else torch.cat(out, dim)


def row_range(n: int, size: int, index: int) -> tuple:
    """Rows [lo, hi) of rank `index` of `size` in an n-row fan-out: shares of
    ceil(n / size) rows in rank order, the last ones short or empty (XLA's
    layout of an uneven sharding)."""
    share = -(-n // size)
    lo = min(index * share, n)
    return lo, min(lo + share, n)


def _all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of `x` over `axis` (a new tensor; `x` is not changed)."""
    group = mesh.group(axis)
    if group is None:
        return x.clone()
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


def _all_gather(x: torch.Tensor, mesh, axis: str) -> list:
    group = mesh.group(axis)
    if group is None:
        return [x]
    out = [torch.empty_like(x) for _ in range(mesh.size(axis))]
    dist.all_gather(out, x.contiguous(), group=group)
    return out


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.mesh, "tp"), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x, mesh, "tp")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over tp (the input of a
    column-parallel linear, whose ranks each see part of its cotangent)."""
    return _CopyToTP.apply(x, mesh)


def reduce_from_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over tp forward (a row-parallel linear's partial outputs);
    the gradient passes through."""
    return _ReduceFromTP.apply(x, mesh)


def _gather(x: torch.Tensor, n: int, mesh) -> torch.Tensor:
    size = mesh.size("dp")
    if mesh.group("dp") is None:
        return x
    share = row_range(n, size, 0)[1]
    pad = share - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    parts = _all_gather(x, mesh, "dp")
    return torch.cat(parts)[:n]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n, mesh):
        ctx.n, ctx.mesh = n, mesh
        return _gather(x, n, mesh)

    @staticmethod
    def backward(ctx, grad):
        lo, hi = row_range(ctx.n, ctx.mesh.size("dp"), ctx.mesh.coord("dp"))
        return grad[lo:hi], None, None


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.n, ctx.mesh = x.shape[0], mesh
        lo, hi = row_range(x.shape[0], mesh.size("dp"), mesh.coord("dp"))
        return x[lo:hi]

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.n, ctx.mesh), None


def gather_rows(x: torch.Tensor, n: int, mesh) -> torch.Tensor:
    """The n-row tensor whose rows `row_range(n, dp, r)` rank r holds in
    `x`: each rank's rows padded with zeros to the largest share, gathered
    over dp, trimmed to n. Backward takes this rank's rows of the
    cotangent (every rank computes the same function of the whole)."""
    return _GatherRows.apply(x, n, mesh)


def scatter_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows `row_range(len(x), dp, r)` of a tensor every rank
    holds whole; backward gathers the rows' cotangents (`gather_rows`)."""
    return _ScatterRows.apply(x, mesh)


def all_reduce_grads(grads: dict, mesh, dp: bool = True) -> dict:
    """The LoRA gradient tree {module: {leaf: tensor}} made whole: the
    leaves of the modules in `mesh.tp_split` (whose base weight tp splits,
    so each rank's gradient holds its slice's share; a replicated module's
    is already whole, `copy_to_tp` having summed its input's gradient)
    summed over tp, then, with `dp`, every leaf averaged over dp. Each step
    is one all-reduce of the leaves flattened into one f32 buffer. Returns
    a new tree."""
    out = {m: dict(e) for m, e in grads.items()}

    def reduce(keys, axis, scale):
        if not keys or mesh.group(axis) is None:
            return
        flat = torch.cat([out[m][k].float().reshape(-1) for m, k in keys])
        flat = _all_reduce(flat, mesh, axis)
        if scale != 1:
            flat = flat / scale
        offset = 0
        for m, k in keys:
            t = out[m][k]
            out[m][k] = flat[offset:offset + t.numel()].reshape(t.shape).to(t.dtype)
            offset += t.numel()

    reduce([(m, k) for m, e in out.items() if m in mesh.tp_split for k in e], "tp", 1)
    if dp:
        reduce([(m, k) for m, e in out.items() for k in e], "dp", mesh.size("dp"))
    return out


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The plain sum of `x` over dp (no autograd): the losses for the
    printout."""
    return _all_reduce(x.detach(), mesh, "dp")


def all_gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Equal shares of rows concatenated in rank order over dp (no
    autograd): a fleet's per-row metrics and adapter rows."""
    return torch.cat(_all_gather(x.detach(), mesh, "dp"))


# --- point to point over the pipeline axis (pp) -------------------------------


def p2p_via_host(mesh, device) -> bool:
    """Whether a send or receive of a tensor on `device` is staged through
    host memory: a CUDA tensor on a gloo mesh (ranks sharing a card; gloo
    refuses CUDA send / recv), which this module copies through host
    buffers itself (`make_mesh` names them in its line); NCCL sends device
    memory directly."""
    return torch.device(device).type == "cuda" and mesh.backend == "gloo"


def _stage_rank(mesh, stage: int) -> int:
    return dist.get_global_rank(mesh.group("pp"), stage)


def isend_tensors(tensors: list, mesh, stage: int, tag: int) -> list:
    """Start sending `tensors`, in order, to pipeline stage `stage` (tags
    tag, tag + 1, ...); returns the pending (work, buffer) pairs for
    `wait_all`."""
    dst = _stage_rank(mesh, stage)
    pending = []
    for i, t in enumerate(tensors):
        buf = t.detach().contiguous()
        if p2p_via_host(mesh, buf.device):
            buf = buf.cpu()
        pending.append((dist.isend(buf, dst, group=mesh.group("pp"), tag=tag + i), buf))
    return pending


def irecv_tensors(specs: list, mesh, stage: int, tag: int, device):
    """Start receiving tensors of `specs` [(shape, dtype), ...] from
    pipeline stage `stage` (the tags of `isend_tensors`); returns
    `finish()`, which waits and returns the tensors on `device`."""
    src = _stage_rank(mesh, stage)
    host = p2p_via_host(mesh, device)
    bufs = [torch.empty(shape, dtype=dtype, device="cpu" if host else device)
            for shape, dtype in specs]
    pending = [(dist.irecv(b, src, group=mesh.group("pp"), tag=tag + i), b)
               for i, b in enumerate(bufs)]

    def finish():
        wait_all(pending)
        return [b.to(device) for b in bufs]

    return finish


def wait_all(pending: list) -> None:
    """Wait for pending sends or receives; each wait is bounded by the
    process group's time-out, so a dead peer fails the run."""
    for work, _ in pending:
        work.wait()


_ACTIVE: Optional[object] = None


@contextlib.contextmanager
def tensor_parallel(mesh):
    """Inside the block the UNet splits the modules of `mesh.tp_split`
    over the mesh's tp axis (`tp_shard`); None or a tp of 1 changes
    nothing."""
    global _ACTIVE
    saved = _ACTIVE
    _ACTIVE = mesh if mesh is not None and mesh.size("tp") > 1 else None
    try:
        yield
    finally:
        _ACTIVE = saved


def active_mesh():
    """The mesh of the innermost `tensor_parallel` block, or None."""
    return _ACTIVE


def tp_shard(module: str, mode: str) -> Optional[TPShard]:
    """This rank's `TPShard` of the linear at dotted path `module` inside
    `tensor_parallel` (its parts as `shard_params` recorded them), or None
    when no mesh is active or tp left the module whole."""
    mesh = _ACTIVE
    if mesh is None or module not in mesh.tp_split:
        return None
    return TPShard(mode, mesh.coord("tp"), mesh.size("tp"), mesh, mesh.tp_parts.get(module, ()))
