"""SD self-attention: the hand-written Hopper kernels and their plain versions.

`sd_attention(q, k, v)` takes (B, H, L, d) tensors. On a CUDA tensor it
launches the forward kernel in `csrc/sd_attention.cu` or raises; on a CPU
tensor it runs `sd_attention_ref`, the plain PyTorch version with the
numerics of `ops/attention.xla_attention` (f32 logits and softmax,
probabilities cast to the input dtype before P.V).

When grad mode is on and an input requires grad, the call goes through
`SdAttention`, a `torch.autograd.Function`: its forward is the same kernel
(or plain version), and its backward on CUDA is the backward kernel in
`csrc/sd_attention_bwd.cu` (`sd_attention_bwd`). On CPU tensors the backward
is autograd through `sd_attention_ref`, as the JAX package differentiates
`xla_attention` off the TPU (`pallas_attention.py:129-133`).
`sd_attention_bwd_ref` is the backward kernel's plain version: the explicit
formula at the kernel's rounding points, used by the tests and
`chip_smoke.py` to hold the kernel to.

The forward kernel replaces `sliders_tpu/ops/pallas_attention.py::_attn_kernel`
and the backward kernel `_attn_bwd_kernel`. At SD1.5's d=40 both are bound by
memory traffic and launch count, not tensor-core rate (about 295 operations
per byte is the H100's bf16 ridge). The forward streams K twice and V once
per 64-row q tile: pass 1 finds each row's softmax max and sum, pass 2 forms
the normalised probabilities, rounds them to the input dtype (the TPU
kernel's rounding point) and multiplies by V. The source files carry the
details.

Each library is built with nvcc at first use into `sliders_tpu_torch/_build/`
(a plain C interface loaded with ctypes), keyed by a hash of its source, the
shared header and the flags; `build_libraries` starts one nvcc per missing
library, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = {"fwd": CSRC / "sd_attention.cu", "bwd": CSRC / "sd_attention_bwd.cu"}
HEADERS = (CSRC / "sd_attention_common.cuh",)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
MAX_D = 128
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# argtypes of the C entry points: pointers, ints, element strides, scale, stream
_SIGNATURES = {
    "fwd": ("sd_attention_fwd", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p]),
    "bwd": ("sd_attention_bwd", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 21 + [ctypes.c_float, ctypes.c_void_p]),
}

_libs: dict = {}
_lib_lock = threading.Lock()


def sd_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain version, and the port's plain attention path
    (`ops/attention.xla_attention`): (B, H, L, d) softmax(q k^T / sqrt(d)) v
    with f32 logits and softmax (plus an additive `mask`), probabilities cast
    to v.dtype before the product."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def sd_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         g: torch.Tensor) -> tuple:
    """Plain version of the backward kernel: (dq, dk, dv) of `sd_attention`
    for the output gradient g, at the TPU kernel's cast points
    (`pallas_attention.py:164-186`): p in f32, dv = round(p)^T g,
    dp = g v^T in f32, dsum = rowsum(dp * p) with p unrounded,
    ds = round(p (dp - dsum)), dq = scale ds k, dk = scale ds^T q; products
    accumulate in f32 and the results are cast to the input dtype."""
    dtype = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(p.to(dtype).float().transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    dsum = (dp * p).sum(dim=-1, keepdim=True)
    ds = (p * (dp - dsum)).to(dtype).float()
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin")


def library_path(name: str) -> Path:
    """Where the build of SOURCES[name] lives, keyed by a hash of the source,
    the shared header and the nvcc flags."""
    digest = hashlib.sha1(SOURCES[name].read_bytes())
    for header in HEADERS:
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{SOURCES[name].stem}_{digest.hexdigest()[:12]}.so"


def build_libraries() -> dict:
    """Compile every kernel library that has no build of its current source
    yet, one nvcc process per source, all started together. Returns
    {name: library path}; the compiler's register/shared-memory report is
    kept beside each library as `.log`. Raises if any build fails."""
    out = {name: library_path(name) for name in SOURCES}
    jobs = {}
    for name, path in out.items():
        if path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        jobs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name].name}: nvcc failed ({proc.returncode}):\n{log}")
            continue
        out[name].with_suffix(".log").write_text(log)
        os.replace(tmp, out[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def _library(name: str):
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lib_lock:
        if name not in _libs:
            path = library_path(name)
            if not path.exists():
                build_libraries()
            lib = ctypes.CDLL(str(path))
            symbol, argtypes = _SIGNATURES[name]
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"sd_attention takes bf16 or f32 q/k/v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"sd_attention takes (B, H, L, d) q/k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, d = q.shape
    if k.shape[0] != B or k.shape[1] != H or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree")
    if d % 8 or not 8 <= d <= MAX_D:
        raise ValueError(f"head dim {d} must be a multiple of 8 in [8, {MAX_D}]")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _kernel_layout(t):
            raise ValueError(f"{name} needs a contiguous last dim and strides that are "
                             f"multiples of 8 on a 16-byte aligned base, got {t.stride()}")


def _kernel_layout(t: torch.Tensor) -> bool:
    """Whether the kernels can read `t` as it lies: contiguous last dim,
    other strides multiples of 8 elements, 16-byte aligned base."""
    return t.stride(3) == 1 and not any(s % 8 for s in t.stride()[:3]) and t.data_ptr() % 16 == 0


def _bhld_buffer(like: torch.Tensor) -> torch.Tensor:
    """An empty (B, H, L, d) view of a (B, L, H, d) buffer, so that merging
    heads afterwards needs no copy."""
    B, H, L, d = like.shape
    return torch.empty((B, L, H, d), dtype=like.dtype, device=like.device).permute(0, 2, 1, 3)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if q.device.type == "cpu":
        return sd_attention_ref(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"sd_attention runs on cpu or cuda, not {q.device}")
    _check(q, k, v)
    B, H, Lq, d = q.shape
    Lk = k.shape[2]
    out = _bhld_buffer(q)
    lib = _library("fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.sd_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, Lq, Lk, d, _DTYPES[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            1.0 / math.sqrt(d), stream,
        )
    if rc != 0:
        raise RuntimeError(f"sd_attention kernel launch failed: CUDA error {rc}")
    sd_attention.launches += 1
    return out


def sd_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     g: torch.Tensor) -> tuple:
    """(dq, dk, dv) of `sd_attention(q, k, v)` for the output gradient g, all
    (B, H, L, d) in the input dtype. CUDA tensors launch the backward kernel
    (a dq kernel, then a dk/dv kernel, on the current stream); CPU tensors
    run `sd_attention_bwd_ref`."""
    if q.device.type == "cpu":
        return sd_attention_bwd_ref(q, k, v, g)
    if q.device.type != "cuda":
        raise ValueError(f"sd_attention_bwd runs on cpu or cuda, not {q.device}")
    _check(q, k, v)
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} does not match q {tuple(q.shape)} {q.dtype}")
    if not _kernel_layout(g):
        g = g.contiguous()
    B, H, Lq, d = q.shape
    Lk = k.shape[2]
    dq, dk, dv = _bhld_buffer(q), _bhld_buffer(k), _bhld_buffer(v)
    stats = torch.empty((3, B, H, Lq), dtype=torch.float32, device=q.device)
    lib = _library("bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.sd_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            B, H, Lq, Lk, d, _DTYPES[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *g.stride()[:3],
            *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
            1.0 / math.sqrt(d), stream,
        )
    if rc != 0:
        raise RuntimeError(f"sd_attention_bwd kernel launch failed: CUDA error {rc}")
    sd_attention_bwd.launches += 1
    return dq, dk, dv


class SdAttention(torch.autograd.Function):
    """`sd_attention` with a gradient: the forward kernel and the backward
    kernel on CUDA; on the CPU the plain version and autograd through it."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        if q.device.type != "cpu":
            return sd_attention_bwd(q, k, v, g)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            return torch.autograd.grad(sd_attention_ref(*leaves), leaves, g)


def sd_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, L, d) non-causal attention with 1/sqrt(d) scaling.

    CPU tensors run the plain version. CUDA tensors launch the kernel on the
    current stream; the result is a (B, H, L, d) view of a (B, L, H, d)
    buffer, so merging heads afterwards needs no copy. When grad mode is on
    and an input requires grad, the result carries a gradient through
    `SdAttention`."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return SdAttention.apply(q, k, v)
    return _forward(q, k, v)


# kernel launches since the last reset; the counts prove a run went through
# the kernels (calls on CPU tensors never reach them)
sd_attention.launches = 0
sd_attention_bwd.launches = 0
