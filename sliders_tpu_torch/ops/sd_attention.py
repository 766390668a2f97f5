"""SD self-attention forward: the hand-written Hopper kernel and its plain version.

`sd_attention(q, k, v)` takes (B, H, L, d) tensors. On a CUDA tensor it
launches the kernel in `csrc/sd_attention.cu` or raises; on a CPU tensor it
runs `sd_attention_ref`, the plain PyTorch version with the numerics of
`ops/attention.xla_attention` (f32 logits and softmax, probabilities cast to
the input dtype before P.V).

The kernel replaces `sliders_tpu/ops/pallas_attention.py::_attn_kernel`. At
SD1.5's d=40 it is bound by memory traffic and launch count, not tensor-core
rate (about 295 operations per byte is the H100's bf16 ridge). It streams K
twice and V once per 64-row q tile: pass 1 finds each row's softmax max and
sum, pass 2 forms the normalised probabilities, rounds them to the input
dtype (the TPU kernel's rounding point) and multiplies by V. The source file
carries the details.

The library is built with nvcc at first use into `sliders_tpu_torch/_build/`
(a plain C interface loaded with ctypes), keyed by a hash of the source.
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
SOURCE = _PKG / "csrc" / "sd_attention.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
MAX_D = 128
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

_lib = None
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


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin")


def build_library() -> Path:
    """Compile csrc/sd_attention.cu for sm_90a unless a build of the same
    source exists. Returns the shared library's path; the compiler's
    register/shared-memory report is kept beside it as `.log`."""
    tag = hashlib.sha1(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libsd_attention_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            fn = lib.sd_attention_fwd
            fn.argtypes = (
                [ctypes.c_void_p] * 4
                + [ctypes.c_int] * 6
                + [ctypes.c_longlong] * 12
                + [ctypes.c_float, ctypes.c_void_p]
            )
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


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
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"{name} needs a contiguous last dim and strides that are "
                             f"multiples of 8, got {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def sd_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, L, d) non-causal attention with 1/sqrt(d) scaling.

    CPU tensors run the plain version. CUDA tensors launch the kernel on the
    current stream; the result is a (B, H, L, d) view of a (B, L, H, d)
    buffer, so merging heads afterwards needs no copy."""
    if q.device.type == "cpu":
        return sd_attention_ref(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"sd_attention runs on cpu or cuda, not {q.device}")
    _check(q, k, v)
    B, H, Lq, d = q.shape
    Lk = k.shape[2]
    out = torch.empty((B, Lq, H, d), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    lib = _library()
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


# kernel launches since the last reset; the count proves a run went through
# the kernel (launches on CPU tensors never reach it)
sd_attention.launches = 0
