#!/usr/bin/env python3
"""Time the attention and conv kernels of this checkout against those of
another checkout (a parent commit) on one GPU, in one process, in turns.

    git archive <parent> sliders_tpu_torch/csrc | tar -x -C <dir>
    python3 attention_ab.py --parent <dir> [--out rows.json] [--only conv]
        [--rounds 3]

The parent's `sliders_tpu_torch/csrc/{sd_attention,sd_attention_bwd,
flash_attention,conv3x3,group_norm}.cu` are compiled with the flags of
`ops/_build.py` into `<dir>/_ab_build/` and loaded with ctypes behind the
same C entry points, so the port's wrappers launch either library on the
same inputs (a parent whose #1 entry takes no scratch, from before the f32
forward's 3xTF32 kernel, behind `ScratchlessFwd`; a parent whose #4
forward entry takes none, from before #4's f32 forward on 3xTF32, behind
`ScratchlessFlash`; a parent's one-pass GroupNorm #8, whose entry takes no
partials scratch or plan, behind `OnePassGroupNorm`). The conv wrappers run the
parent's conv library as the parent's own plan would: a parent with this
checkout's entries (`tf32_split_launch` among
them) as they are; a parent whose Hopper entry takes bf16 only (no dtype
argument, before the f32 Hopper path) with f32 on its generic kernel
(`BF16HopperConv`; it can go once no such parent is timed). The conv cases (kernel
'conv': #5, #7 and #6 at each of chip_smoke.py's batch-16 SD1.5 shapes and
three SDXL ones in bf16; #5 and #7 with a residual at the SD VAE decoder's
f32 shapes at the decode batch; all three at chip_smoke.py's f32
CONV_EXTRA case) are held to the plain versions within chip_smoke.py's
CONV_ULPS bf16 ulps of each element, or f32 F32_TOL of the largest value
(TF32 off on the plain side), and f32 rows print both bounds (FMA and
3xTF32). For every
case both results are held to the unchanged plain versions with the
tolerances of `chip_smoke.py` (4 bf16 ulps at each output's largest
magnitude; f32 1e-5; GroupNorm cases 'gn' at chip_smoke.py's GN_SHAPES
and its f32 shape, beside `F.group_norm` (+ SiLU) and the byte bound), then timed with CUDA events in the order parent,
change, change, parent, `--rounds` times (median of `--runs` samples
each, a sample the mean of back-to-back calls adding up to about 20 ms, so
that the wrapper's host time overlaps the device work and a sample reads
the kernels' time); each side's time is the median of its medians (of
two, their mean). SDPA on the same inputs (the backward in the same
dtype), the plain version and the bound (f32: both bounds, 3xTF32 and FMA)
are printed beside. It prints the card's name and
power limit first and writes every row to `--out` as JSON when given.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from chip_smoke import (  # noqa: E402
    CONV_EXTRA, CONV_SHAPES, CONV_ULPS, F32_TOL, GN_SHAPES, VAE_CONV_SHAPES, VAE_DECODE_BATCH,
    bf16_max_ulps, bf16_tolerance, bound as roofline, conv_case, f32_bounds, graph_ms)

CONV_KERNELS = ("conv3x3", "epi_conv3x3", "fused_conv3x3")

# (kernel, (B, H, L, d), dtype, head views of (B, L, H*d) buffers)
CASES = [
    ("sd", (16, 8, 4096, 40), "bfloat16", False),
    ("sd", (16, 8, 1024, 80), "bfloat16", False),
    ("sd", (16, 10, 4096, 64), "bfloat16", False),
    ("sd", (16, 20, 1024, 64), "bfloat16", False),
    ("sd", (2, 10, 1024, 64), "bfloat16", False),
    ("sd", (2, 24, 4608, 128), "bfloat16", True),
    # #1 in f32 (3xTF32, its split pass in the call): the CFG-doubled denoise
    # of SD1.5's two levels and SDXL's d = 64 at 512 px, FLUX's 1024 px joint
    # attention on head views
    ("sd", (2, 8, 4096, 40), "float32", False),
    ("sd", (2, 8, 1024, 80), "float32", False),
    ("sd", (2, 10, 1024, 64), "float32", False),
    ("sd", (2, 24, 4608, 128), "float32", True),
    ("flash", (1, 24, 16896, 128), "bfloat16", True),
    ("flash", (2, 24, 4608, 128), "bfloat16", True),
    ("flash", (1, 2, 16896, 128), "bfloat16", True),
    ("flash", (8, 1, 16384, 512), "float32", False),
    ("flash", (8, 1, 4096, 512), "float32", False),
    # #4 in bf16 at d = 256 (a test shape and one that fills the card) and in
    # f32 (the one-pass 3xTF32 plans) at the tiny f32 FLUX run's 1280 px and
    # FLUX's 1536 px on head views, and at d = 256
    ("flash", (1, 2, 2048, 256), "bfloat16", False),
    ("flash", (1, 16, 4096, 256), "bfloat16", False),
    ("flash", (1, 2, 6912, 128), "float32", True),
    ("flash", (1, 24, 9728, 128), "float32", True),
    ("flash", (1, 2, 2048, 256), "float32", False),
    ("flash", (1, 16, 4096, 256), "float32", False),
    # the backwards: #2 at every bf16 shape of chip_smoke.py's BWD_SHAPES (FLUX's
    # d = 128 on head views, as its grad pass passes them), #4's dk/dv and dq
    # kernels from the same residuals at FLUX's 2048 px and 1024 px grad passes
    ("sd_bwd", (1, 8, 4096, 40), "bfloat16", False),
    ("sd_bwd", (1, 8, 1024, 80), "bfloat16", False),
    ("sd_bwd", (2, 8, 4096, 40), "bfloat16", False),
    ("sd_bwd", (1, 10, 1024, 64), "bfloat16", False),
    ("sd_bwd", (3, 10, 1024, 64), "bfloat16", False),
    ("sd_bwd", (1, 24, 4096, 128), "bfloat16", True),
    ("sd_bwd", (1, 24, 1536, 128), "bfloat16", True),
    # #2 in f32 (the TF32 plan) at SD1.5's d = 40 and 80, SDXL's 64 and
    # FLUX's 128 below 1536 px (head views)
    ("sd_bwd", (1, 8, 4096, 40), "float32", False),
    ("sd_bwd", (1, 8, 1024, 80), "float32", False),
    ("sd_bwd", (1, 10, 1024, 64), "float32", False),
    ("sd_bwd", (1, 24, 1536, 128), "float32", True),
    ("flash_bwd", (1, 24, 16896, 128), "bfloat16", True),
    ("flash_bwd", (1, 24, 4608, 128), "bfloat16", True),
    # #4's f32 backward (the TF32 plan) at the tiny f32 FLUX run's 1280 px
    # and at FLUX's 1536 px, where f32 first routes to #4
    ("flash_bwd", (1, 2, 6912, 128), "float32", True),
    ("flash_bwd", (1, 24, 9728, 128), "float32", True),
    # #4's bf16 backward at d = 256 (no main path): a test shape and one
    # that fills the card
    ("flash_bwd", (1, 2, 2048, 256), "bfloat16", True),
    ("flash_bwd", (1, 16, 4096, 256), "bfloat16", True),
    # #4's f32 backward at d = 256 and 512 (the TF32 plan on clusters that
    # split d; a parent from before it on the FMA kernels flash_bwd_f32): a
    # test shape, one that fills the card, and the VAE's single head
    ("flash_bwd", (1, 2, 2048, 256), "float32", False),
    ("flash_bwd", (1, 16, 4096, 256), "float32", False),
    ("flash_bwd", (1, 1, 4096, 512), "float32", False),
    # GroupNorm #8 at chip_smoke.py's GN_SHAPES (batch 16, bf16) and its f32 shape
    *(("gn", (16, L, C, silu, eps), "bfloat16", None) for L, C, silu, eps in GN_SHAPES),
    ("gn", (16, 4096, 320, True, 1e-5), "float32", None),
    # the conv kernels: ((B, H, W, C, N, mode), dtype, the kernels timed) at
    # batch 16 in bf16, the VAE decoder's f32 shapes at the decode batch, and
    # the f32 CONV_EXTRA case
    *(("conv", (16, h, h, c, n, mode), "bfloat16", CONV_KERNELS)
      for h, c, n, mode in CONV_SHAPES),
    *(("conv", (16, h, h, c, n, mode), "bfloat16", CONV_KERNELS)
      for h, c, n, mode in ((128, 320, 320, "temb"), (64, 1920, 640, "temb"),
                            (32, 2560, 1280, "temb"))),
    *(("conv", (VAE_DECODE_BATCH, h, h, c, n, "residual"), "float32", CONV_KERNELS[:2])
      for h, c, n in VAE_CONV_SHAPES),
    *(("conv", (b, h, h, c, n, mode), dt, CONV_KERNELS)
      for b, h, c, n, mode, dt in CONV_EXTRA if dt == "float32"),
]
LIBS = {"fwd": "sd_attention.cu", "bwd": "sd_attention_bwd.cu", "flash": "flash_attention.cu",
        "conv": "conv3x3.cu", "group_norm": "group_norm.cu"}


def bounds(shape, dt, backward=False) -> dict:
    """bound_ms and bound_by of an attention call (forward 4 B H L^2 d
    operations over 4 B H L d elements, backward 10 over 7); f32 also both
    of its bounds, 3xTF32 and FMA, the lesser the row's."""
    B, H, L, d = shape
    item = 2 if dt == "bfloat16" else 4
    flops = (10 if backward else 4) * B * H * L * L * d
    nbytes = (7 if backward else 4) * B * H * L * d * item
    if dt == "float32":
        return f32_bounds(flops, nbytes)
    ms, by = roofline(flops, nbytes, dt)
    return {"bound_ms": ms, "bound_by": by}


def median_ms(fn, runs, reps=1):
    """Median over `runs` samples of the device time per call; a sample is
    `reps` calls back to back between two CUDA events, so that with reps > 1
    the wrapper's host time overlaps the device work of the calls before it
    and the sample reads the kernels' time."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


class BF16HopperConv:
    """A parent's conv library whose Hopper entry takes bf16 only (no dtype
    argument): its `conv3x3_launch` as it is, and its `conv3x3_sm90_launch`
    behind this checkout's signature."""

    def __init__(self, lib):
        from sliders_tpu_torch.ops import _build

        self.conv3x3_launch = lib.conv3x3_launch
        self._sm90 = lib.conv3x3_sm90_launch
        P, I, L = _build._P, _build._I, _build._L
        self._sm90.argtypes = [P] * 7 + [I] * 7 + [L] * 6 + [I] * 5 + [P]
        self._sm90.restype = ctypes.c_int

    def conv3x3_sm90_launch(self, *args):
        if args[12]:  # is_f32: the parent's Hopper entry has no f32 path
            raise ValueError("the parent's Hopper conv entry takes bf16 only")
        return self._sm90(*args[:12], *args[13:])


class ScratchlessFwd:
    """A parent's #1 library from before the f32 forward took a scratch (its
    `sd_attention_fwd` has no scratch argument; f32 on the FMA kernel
    `attn_fwd_f32`): that entry behind this checkout's signature, the
    scratch dropped. It can go once no such parent is timed."""

    def __init__(self, lib):
        from sliders_tpu_torch.ops import _build

        self._fwd = lib.sd_attention_fwd
        self._fwd.argtypes = [_build._P] * 4 + [_build._I] * 6 + [_build._L] * 12 + [
            _build._F, _build._P]
        self._fwd.restype = ctypes.c_int

    def sd_attention_fwd(self, q, k, v, o, scratch, *rest):
        return self._fwd(q, k, v, o, *rest)


class ScratchlessFlash:
    """A parent's #4 library from before its f32 forward at d = 128 / 256
    took a scratch (its `flash_attention_fwd` has no scratch argument; those
    head dims on the FMA kernel `flash_fwd_f32`, bf16 d = 256 on
    `flash_fwd_bf16`): that entry behind this checkout's signature, the
    scratch dropped, and its backward entry as it is. It can go once no such
    parent is timed."""

    def __init__(self, lib):
        from sliders_tpu_torch.ops import _build

        self._fwd = lib.flash_attention_fwd
        self._fwd.argtypes = [_build._P] * 5 + [_build._I] * 6 + [_build._L] * 12 + [
            _build._F, _build._P]
        self._fwd.restype = ctypes.c_int
        self.flash_attention_bwd = lib.flash_attention_bwd
        self.flash_attention_bwd.argtypes = _build.LIBRARIES["flash"][2]["flash_attention_bwd"]
        self.flash_attention_bwd.restype = ctypes.c_int

    def flash_attention_fwd(self, q, k, v, o, ml, scratch, *rest):
        return self._fwd(q, k, v, o, ml, *rest)


class OnePassGroupNorm:
    """A parent's #8 library from before the two-pass kernel (its
    `group_norm_launch` takes no partials scratch and no plan): that entry
    behind this checkout's signature, the scratch and the plan dropped. It
    can go once no such parent is timed."""

    def __init__(self, lib):
        from sliders_tpu_torch.ops import _build

        self._gn = lib.group_norm_launch
        self._gn.argtypes = [_build._P] * 4 + [_build._I] * 6 + [_build._F, _build._P]
        self._gn.restype = ctypes.c_int

    def group_norm_launch(self, x, gamma, beta, y, part, B, L, C, groups, is_f32, silu, eps,
                          rows, rpi, stream):
        return self._gn(x, gamma, beta, y, B, L, C, groups, is_f32, silu, eps, stream)


def build_parent(parent: str) -> dict:
    """Compile the parent's attention and conv sources; {name: CDLL} with the
    argtypes of this checkout's entry points that the parent's library has
    (the C interface of each is the same)."""
    from sliders_tpu_torch.ops import _build

    csrc = os.path.join(parent, "sliders_tpu_torch", "csrc")
    out_dir = os.path.join(parent, "_ab_build")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name, src in LIBS.items():
        out = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (out, subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o", out,
                                              os.path.join(csrc, src)],
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"parent {LIBS[name]}: nvcc failed:\n{log}")
        lib = ctypes.CDLL(out)
        if name in ("fwd", "flash"):
            with open(os.path.join(csrc, LIBS[name])) as f:
                text = f.read()
            if name == "fwd" and "attn_fwd_f32" in text:
                libs[name] = ScratchlessFwd(lib)
                continue
            if name == "flash" and "flash_fwd_bf16" in text:
                libs[name] = ScratchlessFlash(lib)
                continue
        if name == "group_norm":
            with open(os.path.join(csrc, LIBS[name])) as f:
                if "group_norm_kernel" in f.read():
                    libs[name] = OnePassGroupNorm(lib)
                    continue
        bf16_hopper = name == "conv" and not hasattr(lib, "tf32_split_launch")
        for symbol, argtypes in _build.LIBRARIES[name][2].items():
            if hasattr(lib, symbol) and not (bf16_hopper and symbol == "conv3x3_sm90_launch"):
                fn = getattr(lib, symbol)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[name] = BF16HopperConv(lib) if bf16_hopper else lib
    print(f"[ab] parent libraries built in {time.perf_counter() - t0:.1f} s", flush=True)
    return libs


class Using:
    """Route the port's wrappers to the parent's libraries inside the block,
    the conv wrappers with the plan the parent's library can run: this
    checkout's for a parent with its entries; for a `BF16HopperConv`, bf16
    as this checkout plans it and f32 on the generic kernel."""

    def __init__(self, libs):
        self.libs = libs

    def __enter__(self):
        import torch

        from sliders_tpu_torch.ops import _build
        from sliders_tpu_torch.ops import conv3x3 as tc

        self.saved = {n: _build.library(n) for n in self.libs}
        _build._libs.update(self.libs)
        self.plan = plan = tc.plan
        lib = self.libs.get("conv")
        if isinstance(lib, BF16HopperConv):
            def parent_plan(x_shape, n, dtype, *args, **kwargs):
                if dtype == torch.bfloat16:
                    return plan(x_shape, n, dtype, *args, **kwargs)
                return tc.Plan("generic")

            tc.plan = parent_plan

    def __exit__(self, *exc):
        from sliders_tpu_torch.ops import _build
        from sliders_tpu_torch.ops import conv3x3 as tc

        _build._libs.update(self.saved)
        tc.plan = self.plan


def bf16_tol(ref_max: float) -> float:
    return 4.0 * 2.0 ** (math.floor(math.log2(max(ref_max, 2.0**-20))) - 7)


def run_case(kernel, shape, dt, views, parent_libs, runs, rounds, gen):
    import torch
    import torch.nn.functional as F

    from sliders_tpu_torch.ops import flash_attention as fa
    from sliders_tpu_torch.ops import sd_attention as sa

    dtype = getattr(torch, dt)
    B, H, L, d = shape
    if views:
        qkv = [torch.randn((B, L, H * d), generator=gen, device="cuda").to(dtype)
               .view(B, L, H, d).permute(0, 2, 1, 3) for _ in range(4)]
    else:
        qkv = [torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4)]
    q, k, v, g = qkv
    if kernel == "sd":
        call, plain = (lambda: sa.sd_attention(q, k, v)), (lambda: sa.sd_attention_ref(q, k, v))
        library = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
        lib_names = ("fwd",)
    elif kernel == "flash":
        call = lambda: fa.flash_attention(q, k, v)  # noqa: E731
        plain = lambda: fa.flash_attention_ref(q, k, v)  # noqa: E731
        library = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
        lib_names = ("flash",)
    else:
        if kernel == "sd_bwd":
            call = lambda: sa.sd_attention_bwd(q, k, v, g)  # noqa: E731
            plain = lambda: sa.sd_attention_bwd_ref(q, k, v, g)  # noqa: E731
            lib_names = ("bwd",)
        else:  # flash_bwd: the residual forward once, then the two kernels
            o, m, l = fa._forward(q, k, v, residuals=True)
            call = lambda: fa.flash_attention_bwd(q, k, v, o, g, m, l)  # noqa: E731
            plain = lambda: fa.flash_attention_bwd_ref(q, k, v, o, g, m, l)  # noqa: E731
            lib_names = ("flash",)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        so = F.scaled_dot_product_attention(*leaves)
        library = lambda: torch.autograd.grad(so, leaves, g, retain_graph=True)  # noqa: E731
    parent = {n: parent_libs[n] for n in lib_names}
    # the plain version in pieces of heads where its L x L logits would be
    # large; each output (o, or dq, dk, dv) one list of pieces
    refs = []
    step = max(1, min(H, int(2**31 // (B * L * L * 4))))
    for h in range(0, H, step):
        part = (slice(None), slice(h, h + step))
        if kernel == "sd":
            out = (sa.sd_attention_ref(q[part], k[part], v[part]),)
        elif kernel == "flash":
            out = (fa.flash_attention_ref(q[part], k[part], v[part]),)
        elif kernel == "sd_bwd":
            out = sa.sd_attention_bwd_ref(q[part], k[part], v[part], g[part])
        else:
            out = fa.flash_attention_bwd_ref(q[part], k[part], v[part], o[part], g[part],
                                             m[part], l[part])
        refs.append([t.float() for t in out])
    ref = [torch.cat(pieces, 1) for pieces in zip(*refs)]
    del refs
    # each output held to its own tolerance: bf16 4 ulps at its largest
    # magnitude, f32 1e-5; a side's error is its worst output's, as a share
    # of that output's tolerance
    tols = [bf16_tol(r.abs().max().item()) if dtype == torch.bfloat16 else 1e-5 for r in ref]
    errs, shares = {}, {}
    for side, libs in (("parent", parent), ("change", {})):
        with Using(libs):
            out = call()
        out = out if isinstance(out, tuple) else (out,)
        torch.cuda.synchronize()
        each = [(a.float() - r).abs().max().item() for a, r in zip(out, ref)]
        shares[side] = max(e / t for e, t in zip(each, tols))
        errs[side] = max(each)
        del out
    tol = min(tols)
    del ref
    torch.cuda.empty_cache()
    # enough back-to-back calls for about 20 ms a sample (from one timed call)
    reps = max(1, min(50, int(20.0 / max(median_ms(call, 1), 1e-3))))
    times = {"parent": [], "change": []}
    for side in ("parent", "change", "change", "parent") * rounds:
        with Using(parent if side == "parent" else {}):
            times[side].append(median_ms(call, runs, reps))
    row = {"kernel": kernel, "shape": shape, "dtype": dt, "views": views, "tol": tol,
           "err_parent": errs["parent"], "err_change": errs["change"],
           "parent_ms": statistics.median(times["parent"]),
           "change_ms": statistics.median(times["change"]),
           "parent_ms_each": times["parent"], "change_ms_each": times["change"],
           "library_ms": median_ms(library, runs, reps), "reps": reps,
           **bounds(shape, dt, backward=kernel.endswith("_bwd"))}
    big = B * H * L * L * 4 > 2**33
    row["plain_ms"] = None if big else median_ms(plain, 3)
    row["err_share_parent"], row["err_share_change"] = shares["parent"], shares["change"]
    row["ok"] = shares["change"] <= 1.0
    print(f"[ab] {kernel} {shape} {dt}{' views' if views else ''}: err parent {errs['parent']:.3g} "
          f"change {errs['change']:.3g} (worst output at {shares['change']:.2f} of its tolerance, "
          f"parent {shares['parent']:.2f}; least tol {tol:.3g}); parent {row['parent_ms']:.4f} ms "
          f"{['%.4f' % t for t in times['parent']]}, change {row['change_ms']:.4f} ms "
          f"{['%.4f' % t for t in times['change']]} ({row['change_ms'] / row['parent_ms']:.3f}x); "
          f"library {row['library_ms']:.4f}, plain "
          f"{'not timed' if row['plain_ms'] is None else '%.4f' % row['plain_ms']}; bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']})"
          + (f"; bounds 3xTF32 {row['tf32x3_bound_ms']:.4f}, FMA {row['fma_bound_ms']:.4f} ms"
             if "fma_bound_ms" in row else ""), flush=True)
    return row


def run_conv_case(shape, dt, names, parent_libs, runs, rounds, gen):
    """The kernels `names` of #5, #7 and #6 at one (B, H, W, C, N, mode):
    each held to its plain version on both sides (bf16 within CONV_ULPS bf16
    ulps of each element, f32 within F32_TOL of the largest value), then
    timed parent, change, change, parent, `rounds` times; cuDNN's conv + bias and each
    kernel's PyTorch expression (as chip_smoke.py times them) beside."""
    import torch
    import torch.nn.functional as F

    from sliders_tpu_torch.ops import conv3x3 as tc

    B, H, W, C, N, mode = shape
    dtype = getattr(torch, dt)
    x, a, s, w, b, extra = conv_case(B, H, C, N, mode, dtype, gen)
    xc = x.permute(0, 3, 1, 2)
    extra_c = (None if extra is None else extra[:, :, None, None] if mode == "temb"
               else extra.permute(0, 3, 1, 2))

    def expression(inp):
        y = F.conv2d(inp, w, b, padding=1)
        return y if extra_c is None else y + extra_c

    kernels = [("conv3x3", lambda: tc.conv3x3(x, w, b), lambda: tc.conv3x3_ref(x, w, b),
                lambda: F.conv2d(xc, w, b, padding=1), 0),
               ("epi_conv3x3", lambda: tc.epi_conv3x3(x, w, b, extra, mode),
                lambda: tc.epi_conv3x3_ref(x, w, b, extra, mode), lambda: expression(xc), 0),
               ("fused_conv3x3", lambda: tc.fused_conv3x3(x, a, s, w, b, extra, mode),
                lambda: tc.fused_conv3x3_ref(x, a, s, w, b, extra, mode),
                lambda: expression(F.silu(xc.float() * a[:, :, None, None]
                                          + s[:, :, None, None]).to(dtype)), 8 * B * C)]
    kernels = [k for k in kernels if k[0] in names]
    extra_n = {"none": 0, "temb": B * N, "residual": B * H * W * N}[mode]
    item = 2 if dt == "bfloat16" else 4
    rows = []
    for name, call, plain, library, fold_bytes in kernels:
        ref = plain()
        ulps = {}  # bf16: the worst element's ulps; f32: the error as a share of F32_TOL
        tol = F32_TOL * max(1.0, ref.float().abs().max().item())
        for side, libs in (("parent", parent_libs), ("change", {})):
            with Using(libs):
                out = call()
            torch.cuda.synchronize()
            ulps[side] = (bf16_max_ulps(out, ref) if dt == "bfloat16" else
                          (out.float() - ref.float()).abs().max().item() / tol)
            del out
        del ref
        reps = max(1, min(50, int(20.0 / max(median_ms(call, 1), 1e-3))))
        times = {"parent": [], "change": []}
        for side in ("parent", "change", "change", "parent") * rounds:
            with Using(parent_libs if side == "parent" else {}):
                times[side].append(median_ms(call, runs, reps))
        nbytes = item * (B * H * W * C + 9 * C * N + N + extra_n + B * H * W * N) + fold_bytes
        row = {"kernel": name, "shape": shape, "dtype": dt,
               **({"tol_ulps": CONV_ULPS, "ulps_parent": ulps["parent"],
                   "ulps_change": ulps["change"]} if dt == "bfloat16" else
                  {"tol": tol, "err_share_parent": ulps["parent"],
                   "err_share_change": ulps["change"]}),
               "parent_ms": statistics.median(times["parent"]),
               "change_ms": statistics.median(times["change"]),
               "parent_ms_each": times["parent"], "change_ms_each": times["change"],
               "library_ms": median_ms(library, runs, reps), "plain_ms": median_ms(plain, 3),
               "reps": reps}
        flops = 2 * 9 * B * H * W * C * N
        if dt == "bfloat16":
            row["bound_ms"], row["bound_by"] = roofline(flops, nbytes, dt)
            row["ok"] = max(ulps.values()) <= CONV_ULPS
            shown = (f"{ulps['parent']:.2f} / {ulps['change']:.2f} bf16 ulps (parent / change, "
                     f"tol {CONV_ULPS})")
        else:
            row.update(f32_bounds(flops, nbytes))
            row["ok"] = max(ulps.values()) <= 1.0
            shown = (f"err {ulps['parent']:.3f} / {ulps['change']:.3f} of tol {tol:.3g} (parent / "
                     f"change); bounds FMA {row['fma_bound_ms']:.4f}, 3xTF32 "
                     f"{row['tf32x3_bound_ms']:.4f} ms")
        print(f"[ab] {name} {shape} {dt}: {shown}; parent {row['parent_ms']:.4f} ms "
              f"{['%.4f' % t for t in times['parent']]}, change {row['change_ms']:.4f} ms "
              f"{['%.4f' % t for t in times['change']]} "
              f"({row['change_ms'] / row['parent_ms']:.3f}x); library {row['library_ms']:.4f}, "
              f"plain {row['plain_ms']:.4f}; bound {row['bound_ms']:.4f} ms ({row['bound_by']})",
              flush=True)
        rows.append(row)
    return rows


def run_gn_case(shape, dt, parent_libs, runs, rounds, gen):
    """#8 at one (B, L, C, silu, eps): both sides held to
    fused_group_norm_ref as chip_smoke.py holds it (bf16 4 ulps at the
    largest magnitude, f32 1e-5 of it), then timed parent, change, change,
    parent, `rounds` times; F.group_norm (+ SiLU) on the channels-first view
    and the byte bound (x read once, y written once) beside. A call at the
    small shapes takes less device time than its wrapper's host time, which
    those samples then read; so each side's and the library's device time
    is also taken from a CUDA graph of calls on copies of x that together
    outgrow L2 (`graph_ms`), in the order parent, change, change, parent."""
    import torch
    import torch.nn.functional as F

    from sliders_tpu_torch.ops import group_norm as tg

    B, L, C, silu, eps = shape
    dtype = getattr(torch, dt)
    x = (torch.randn((B, L, C), generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    gamma = 1.0 + 0.2 * torch.randn(C, generator=gen, device="cuda")
    beta = 0.3 * torch.randn(C, generator=gen, device="cuda")
    call = lambda: tg.fused_group_norm(x, gamma, beta, 32, eps, silu)  # noqa: E731
    ref = tg.fused_group_norm_ref(x, gamma, beta, 32, eps, silu).float()
    ref_max = ref.abs().max().item()
    tol = bf16_tolerance(ref_max) if dtype == torch.bfloat16 else 1e-5 * max(1.0, ref_max)
    errs = {}
    for side, libs in (("parent", parent_libs), ("change", {})):
        with Using(libs):
            out = call()
        torch.cuda.synchronize()
        errs[side] = (out.float() - ref).abs().max().item()
        del out
    del ref
    xc, gc_, bc = x.transpose(1, 2), gamma.to(dtype), beta.to(dtype)

    def library():
        y = F.group_norm(xc, 32, gc_, bc, eps)
        return F.silu(y) if silu else y

    reps = max(1, min(50, int(20.0 / max(median_ms(call, 1), 1e-3))))
    times = {"parent": [], "change": []}
    for side in ("parent", "change", "change", "parent") * rounds:
        with Using(parent_libs if side == "parent" else {}):
            times[side].append(median_ms(call, runs, reps))
    item = 2 if dt == "bfloat16" else 4
    # up to 16 copies of x, reading up to 128 MB in all (the small shapes' copies fit L2)
    xs = [x] + [x.clone() for _ in range(min(15, (2**27 - 1) // (B * L * C * item)))]
    calls = [lambda xi=xi: tg.fused_group_norm(xi, gamma, beta, 32, eps, silu) for xi in xs]
    graphs = {"parent": [], "change": []}
    for side in ("parent", "change", "change", "parent"):
        with Using(parent_libs if side == "parent" else {}):
            graphs[side].append(graph_ms(calls))
    lib_graph = graph_ms([lambda xi=xi: (F.silu if silu else (lambda t: t))(
        F.group_norm(xi.transpose(1, 2), 32, gc_, bc, eps)) for xi in xs])
    del xs, calls
    bound_ms, bound_by = roofline(8 * B * L * C, 2 * item * B * L * C + 8 * C, "float32")
    row = {"kernel": "gn", "shape": shape, "dtype": dt, "tol": tol, "err_parent": errs["parent"],
           "err_change": errs["change"], "parent_ms": statistics.median(times["parent"]),
           "change_ms": statistics.median(times["change"]), "parent_ms_each": times["parent"],
           "change_ms_each": times["change"], "library_ms": median_ms(library, runs, reps),
           "plain_ms": median_ms(lambda: tg.fused_group_norm_ref(x, gamma, beta, 32, eps, silu), 3),
           "reps": reps, "bound_ms": bound_ms, "bound_by": bound_by,
           "graph_parent_ms": statistics.mean(graphs["parent"]),
           "graph_change_ms": statistics.mean(graphs["change"]), "graph_library_ms": lib_graph,
           "ok": errs["change"] <= tol}
    print(f"[ab] gn {shape} {dt}: err parent {errs['parent']:.3g} change {errs['change']:.3g} "
          f"(tol {tol:.3g}); parent {row['parent_ms']:.4f} ms "
          f"{['%.4f' % t for t in times['parent']]}, change {row['change_ms']:.4f} ms "
          f"{['%.4f' % t for t in times['change']]} ({row['change_ms'] / row['parent_ms']:.3f}x); "
          f"library {row['library_ms']:.4f}, plain {row['plain_ms']:.4f}; bound {bound_ms:.4f} ms "
          f"({bound_by}; change at {bound_ms / row['change_ms']:.1%} of it); in CUDA graphs "
          f"parent {row['graph_parent_ms']:.4f} ms {['%.4f' % t for t in graphs['parent']]}, "
          f"change {row['graph_change_ms']:.4f} ms {['%.4f' % t for t in graphs['change']]} "
          f"({row['graph_change_ms'] / row['graph_parent_ms']:.3f}x, at "
          f"{bound_ms / row['graph_change_ms']:.1%} of the bound), library {lib_graph:.4f} ms",
          flush=True)
    return row


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="directory holding the parent's csrc")
    ap.add_argument("--out", default=None, help="write the rows here as JSON")
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=1,
                    help="turns of parent, change, change, parent for each case")
    ap.add_argument("--only", default="",
                    help="comma-separated kernels (sd, flash, sd_bwd, flash_bwd, conv, gn)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_ab: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sliders_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_libraries()
    print(f"[ab] this checkout's libraries built in {time.perf_counter() - t0:.1f} s", flush=True)
    parent_libs = build_parent(args.parent)
    only = set(filter(None, args.only.split(",")))
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for case in CASES:
        if only and case[0] not in only:
            continue
        if case[0] == "conv":
            rows.extend(run_conv_case(*case[1:], {"conv": parent_libs["conv"]}, args.runs,
                                      args.rounds, gen))
        elif case[0] == "gn":
            rows.append(run_gn_case(*case[1:3], {"group_norm": parent_libs["group_norm"]},
                                    args.runs, args.rounds, gen))
        else:
            rows.append(run_case(*case, parent_libs, args.runs, args.rounds, gen))
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    bad = [r for r in rows if not r["ok"]]
    print(f"[ab] {len(rows) - len(bad)} of {len(rows)} cases within tolerance", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
