"""Build and load the port's CUDA kernel libraries.

Each source in `csrc/` is compiled by nvcc for sm_90a into a shared library
with a plain C interface, loaded with ctypes (no PyTorch headers, so a build
takes seconds). A library lives in `sliders_tpu_torch/_build/`, keyed by a
hash of its source, the headers it includes and the flags;
`build_libraries` starts one nvcc per library that has no current build,
all at once, so the first call builds every kernel of the package in
parallel. The compiler's register and shared-memory report (`-Xptxas -v`)
is kept beside each library as `.log`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# name -> (source, every header it includes, directly or through another
# header: they key the build, and tests/test_torch_build.py holds the list to
# the sources' #include lines; {C entry point: argtypes}); pointers and the
# stream are c_void_p (a Python int would be cut to 32 bits)
LIBRARIES = {
    "fwd": (CSRC / "sd_attention.cu", (CSRC / "sd_attention_common.cuh",
                                       CSRC / "attention_sm90.cuh",
                                       CSRC / "attention_bwd_sm90.cuh",
                                       CSRC / "attention_fwd_tf32.cuh", CSRC / "sm90_ptx.cuh"), {
        # q, k, v, o, scratch; B, H, Lq, Lk, d, dtype (0 bf16, 1 f32, 2 f16);
        # q/k/v/o strides; scale, stream
        "sd_attention_fwd": [_P] * 5 + [_I] * 6 + [_L] * 12 + [_F, _P],
    }),
    "bwd": (CSRC / "sd_attention_bwd.cu", (CSRC / "sd_attention_common.cuh",
                                           CSRC / "attention_sm90.cuh",
                                           CSRC / "attention_bwd_sm90.cuh",
                                           CSRC / "sm90_ptx.cuh"), {
        # q, k, v, g, dq, dk, dv, stats; B, H, Lq, Lk, d, dtype (as the
        # forward's); q/k/v/g/dq/dk/dv strides; scale, stream
        "sd_attention_bwd": [_P] * 8 + [_I] * 6 + [_L] * 21 + [_F, _P],
    }),
    "flash": (CSRC / "flash_attention.cu", (CSRC / "sd_attention_common.cuh",
                                            CSRC / "attention_sm90.cuh",
                                            CSRC / "attention_bwd_sm90.cuh",
                                            CSRC / "attention_fwd_tf32.cuh",
                                            CSRC / "sm90_ptx.cuh"), {
        # q, k, v, o, ml, scratch; B, H, Lq, Lk, d, is_f32; q/k/v/o strides;
        # scale, stream
        "flash_attention_fwd": [_P] * 6 + [_I] * 6 + [_L] * 12 + [_F, _P],
        # q, k, v, do, m, l, di, dq, dk, dv; B, H, Lq, Lk, d, is_f32, part;
        # q/k/v/do/dq/dk/dv strides; scale, stream
        "flash_attention_bwd": [_P] * 10 + [_I] * 7 + [_L] * 21 + [_F, _P],
    }),
    "conv": (CSRC / "conv3x3.cu", (CSRC / "conv3x3.cuh", CSRC / "conv3x3_sm90.cuh",
                                   CSRC / "sm90_ptx.cuh"), {
        # x, w, bias, extra, a, s, y; B, H, W, C, N, dtype (0 bf16, 1 f32,
        # 2 f16), mode, prologue;
        # x strides (b, h, w), extra strides (b, h, w); stream
        "conv3x3_launch": [_P] * 7 + [_I] * 8 + [_L] * 6 + [_P],
        # the same, then the tile plan: TR, TC, BN, stages, shared-memory
        # bytes (f32: w is tf32_split_launch's split of the weight)
        "conv3x3_sm90_launch": [_P] * 7 + [_I] * 8 + [_L] * 6 + [_I] * 5 + [_P],
        # w, out (2 x n f32), n, stream
        "tf32_split_launch": [_P, _P, _L, _P],
    }),
    "group_norm": (CSRC / "group_norm.cu", (), {
        # x, gamma, beta, y, partials; B, L, C, groups, is_f32, silu; eps;
        # rows, rpi (ops/group_norm.plan); stream
        "group_norm_launch": [_P] * 5 + [_I] * 6 + [_F] + [_I] * 2 + [_P],
    }),
    "layout_pin": (CSRC / "layout_pin.cu", (), {
        # x, y; B, L, C; x strides (b, l, c) in elements; element bytes; stream
        "layout_pin_launch": [_P] * 2 + [_I] * 3 + [_L] * 3 + [_I, _P],
    }),
}
SOURCES = {name: lib[0] for name, lib in LIBRARIES.items()}

_libs: dict = {}
_lib_lock = threading.Lock()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin")


def library_path(name: str) -> Path:
    """Where the build of LIBRARIES[name] lives, keyed by a hash of the
    source, its headers and the nvcc flags."""
    source, headers, _ = LIBRARIES[name]
    digest = hashlib.sha1(source.read_bytes())
    for header in headers:
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:12]}.so"


def build_libraries() -> dict:
    """Compile every library that has no build of its current source yet,
    one nvcc process per source, all started together. Returns {name:
    library path}; the compiler's report is kept beside each library as
    `.log`. Raises if any build fails."""
    out = {name: library_path(name) for name in LIBRARIES}
    jobs = {}
    for name, path in out.items():
        if path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
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


def library(name: str):
    """The loaded library LIBRARIES[name] with its entry points' argtypes
    set (building every missing library first)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lib_lock:
        if name not in _libs:
            path = library_path(name)
            if not path.exists():
                build_libraries()
            lib = ctypes.CDLL(str(path))
            for symbol, argtypes in LIBRARIES[name][2].items():
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]

