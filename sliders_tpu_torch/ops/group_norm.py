"""One-pass GroupNorm (+ SiLU) over (B, L, C): the hand-written Hopper
kernel #8 and its plain version (counterpart of
sliders_tpu/ops/pallas_groupnorm.py).

`fused_group_norm(x, gamma, beta, num_groups, eps, act_silu)` launches the
kernel in `csrc/group_norm.cu` on a CUDA tensor, or raises; on a CPU tensor
it runs `fused_group_norm_ref`, the TPU kernel's formula
(`pallas_groupnorm.py:43-78`): f32 sums and sums of squares per group,
var = E[x^2] - mean^2, the per-channel scale a = rsqrt(var + eps) * gamma
and shift b = beta - mean * rsqrt * gamma folded in f32 and rounded to the
input dtype, y = x * a + b in the input dtype, and the SiLU's sigmoid taken
in f32 and rounded before its product.

On the card the kernel takes two passes over x (`plan` picks their chunks
of rows): per-chunk group partial sums read by 16-byte vectors along the
rows, then a pass that folds the partials in chunk order and writes y;
`fused_group_norm_chunked` is the plain version with that order of the f32
sums, for the CPU tests.

Like the JAX package (`ops/basic.py:234-237`), the port routes this kernel
nowhere: `ops/basic.group_norm` stays the UNet's path (its statistics are
two-pass f32 and it rounds at other points), and `chip_smoke.py` holds the
kernel against its plain version. It has no gradient: the JAX package's
backward recomputes `basic.group_norm`, which is reachable directly.
"""

from __future__ import annotations

import functools

import torch

from sliders_tpu_torch.ops import _build

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
SMS = 132  # the H100's SMs: the plan aims at about four blocks on each
THREADS = 256  # about this many threads a block (a whole number of rows' vectors)


def plan(B: int, L: int, C: int, dtype: torch.dtype) -> tuple:
    """(V, rpi, rows, chunks) of the kernel at (B, L, C): V values a 16-byte
    vector, rpi rows a pass of a block's C / V * rpi threads, `rows` rows a
    block (its chunk of one batch), `chunks` blocks a batch and pass. A
    thread sums its V channels over at least about four passes, and a pass
    has about 4 SMS blocks. Depends on the shapes only, so its order of the
    sums is the same on every card."""
    return _plan(B, L, C, torch.empty((), dtype=dtype).element_size())


@functools.lru_cache(maxsize=256)
def _plan(B: int, L: int, C: int, itemsize: int) -> tuple:
    vec = 16 // itemsize
    rpi = max(1, THREADS // (C // vec))
    chunks = max(1, min(-(-L // (4 * rpi)), -(-4 * SMS // B)))
    rows = -(-L // chunks)
    return vec, rpi, rows, -(-L // rows)


def fused_group_norm_chunked(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                             num_groups: int = 32, eps: float = 1e-5,
                             act_silu: bool = False) -> torch.Tensor:
    """`fused_group_norm_ref` with the kernel's order of the f32 sums (its
    `plan`): per chunk of rows, each thread's per-channel sums over its rows
    in order (a product and a sum for each square, where the kernel takes
    one fma), summed over the block's row threads and then the group's
    channels, then the chunks' partials in chunk order. The rest is
    `fused_group_norm_ref`'s arithmetic."""
    B, L, C = x.shape
    vec, rpi, rows, chunks = plan(B, L, C, x.dtype)
    cg = C // num_groups
    xf = x.float()
    parts = []
    for c in range(chunks):
        xc = xf[:, c * rows:min((c + 1) * rows, L)]
        s = torch.zeros((B, rpi, C))
        q = torch.zeros((B, rpi, C))
        for r in range(0, xc.shape[1], rpi):  # pass r: row r + rr for thread row rr
            v = xc[:, r:r + rpi]
            s[:, :v.shape[1]] += v
            q[:, :v.shape[1]] += v * v
        # the block's fold: over the row threads, then the group's channels, in order
        gs = torch.zeros((B, num_groups))
        gq = torch.zeros((B, num_groups))
        for k in range(rpi):
            for j in range(cg):
                gs += s[:, k, j::cg]
                gq += q[:, k, j::cg]
        parts.append((gs, gq))
    total, total_sq = torch.zeros((B, num_groups)), torch.zeros((B, num_groups))
    for gs, gq in parts:
        total += gs
        total_sq += gq
    n = L * cg
    mean = total / n
    var = total_sq / n - mean * mean
    inv = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(cg, dim=-1)[:, None, :]
    inv_c = inv.repeat_interleave(cg, dim=-1)[:, None, :]
    g, b = gamma.float(), beta.float()
    a = (inv_c * g).to(x.dtype)
    shift = (b - mean_c * inv_c * g).to(x.dtype)
    y = x * a + shift
    if act_silu:
        y = y * torch.sigmoid(y.float()).to(x.dtype)
    return y


def fused_group_norm_ref(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         num_groups: int = 32, eps: float = 1e-5,
                         act_silu: bool = False) -> torch.Tensor:
    """Plain version of kernel #8 (see the module docstring)."""
    B, L, C = x.shape
    cg = C // num_groups
    xg = x.reshape(B, L, num_groups, cg).float()
    n = L * cg
    mean = xg.sum(dim=(1, 3)) / n  # (B, G)
    var = (xg * xg).sum(dim=(1, 3)) / n - mean * mean
    inv = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(cg, dim=-1)[:, None, :]
    inv_c = inv.repeat_interleave(cg, dim=-1)[:, None, :]
    g, b = gamma.float(), beta.float()
    a = (inv_c * g).to(x.dtype)
    shift = (b - mean_c * inv_c * g).to(x.dtype)
    y = x * a + shift
    if act_silu:
        y = y * torch.sigmoid(y.float()).to(x.dtype)
    return y


def fused_group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     num_groups: int = 32, eps: float = 1e-5,
                     act_silu: bool = False) -> torch.Tensor:
    """GroupNorm (+ SiLU) of (B, L, C) x with (C,) gamma and beta; the
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if x.ndim != 3 or x.shape[2] % num_groups or tuple(gamma.shape) != (x.shape[2],) or (
            tuple(beta.shape) != (x.shape[2],)):
        raise ValueError(f"takes (B, L, C) x with C a multiple of {num_groups} and (C,) "
                         f"gamma/beta, got {tuple(x.shape)}, {tuple(gamma.shape)}, "
                         f"{tuple(beta.shape)}")
    if x.device.type == "cpu":
        return fused_group_norm_ref(x, gamma, beta, num_groups, eps, act_silu)
    if x.device.type != "cuda":
        raise ValueError(f"fused_group_norm runs on cpu or cuda, not {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused_group_norm takes bf16 or f32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"fused_group_norm needs a contiguous (B, L, C) x, got strides "
                         f"{x.stride()}")
    if gamma.device != x.device or beta.device != x.device:
        raise ValueError("gamma and beta must be on x's device")
    if gamma.stride(0) != 1 or beta.stride(0) != 1:
        raise ValueError(f"fused_group_norm needs contiguous gamma and beta, got strides "
                         f"{gamma.stride()} and {beta.stride()}")
    B, L, C = x.shape
    vec, rpi, rows, chunks = _plan(B, L, C, x.element_size())
    if C % vec or C // vec > 1024 or x.data_ptr() % 16:
        raise ValueError(f"fused_group_norm's kernel reads 16-byte vectors: it takes C a "
                         f"multiple of {vec} and at most {1024 * vec} on a 16-byte aligned x, "
                         f"got C {C} at address {x.data_ptr()}")
    g = gamma.float()  # (C,) parameters, read in f32 as the TPU kernel does
    b = beta.float()
    y = torch.empty_like(x)
    part = torch.empty(B * chunks * num_groups * 2, dtype=torch.float32, device=x.device)
    lib = _build.library("group_norm")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.group_norm_launch(x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
                                   part.data_ptr(), B, L, C, num_groups, _DTYPES[x.dtype],
                                   int(act_silu), float(eps), rows, rpi, stream)
    if rc != 0:
        raise RuntimeError(f"fused_group_norm kernel launch failed: CUDA error {rc}")
    fused_group_norm.launches += 1
    return y


# kernel launches since the last reset (CPU calls are not counted)
fused_group_norm.launches = 0
