#!/usr/bin/env python3
"""Drive the PyTorch port's SD1.5 slider serving and slider training once on
one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of the repository

Phases, each printing one line or a few before the last:
  1. device: the card's name and power limit (nvidia-smi), torch/CUDA/nvcc.
  2. build:  nvcc builds the attention forward and backward kernels
     (sliders_tpu_torch/csrc/sd_attention*.cu) for sm_90a, in parallel.
  3. kernel: the forward kernel against its plain PyTorch version at the
     serving shapes, the backward kernel against its plain version at the
     grad-pass shapes (error of dq/dk/dv and median time of each), then the
     tiny slice at 256 px and three tiny training steps at 256 px on the GPU
     (through the kernels) against the CPU (plain paths) in f32.
  4. engine: an SD1.5 SliderEngine at full width (UNet SD15, CLIP-L, SD VAE,
     512 px, DDIM 50, guidance 7.5, start_noise 750) in bf16 with seeded
     random weights and two rank-4 noxattn sliders, behind the HTTP server;
     one UNet step timed through the kernel and on the plain attention
     path, its device time by kernel class, and one VAE decode; then the
     training grad pass (batch 1, remat) on the same UNet through both
     kernels against the plain attention path, in alternating rounds.
  5. http:   /generate with five scales, two concurrent /generate calls for
     the two sliders (coalesced into one stacked batch), /healthz; every
     reply is checked, and the kernel's launch count must equal
     10 routed self-attentions x 50 steps x the denoise batches.
  6. train:  a full-width SD1.5 snapshot with seeded random weights (UNet +
     CLIP-L + tokenizer, no VAE) written to a temporary directory, then the
     training CLI in-process with the values of data/config.yaml (bf16,
     remat, rank-4 noxattn, AdamW lr 2e-4, DDIM 50) for a few iterations,
     and a resume from its state file; losses, the moved LoRA, the frozen
     alphas, the saved files and the launch counts of both kernels are
     checked, and the time per iteration is split by phase.
The last line is {"ok": true, "device": {...}}; any failure raises, exits
non-zero and prints no such line. It needs a CUDA device and the rest of
the repository beside it.
"""

from __future__ import annotations

import base64
import gc
import json
import math
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import zlib

REPO = os.path.dirname(os.path.abspath(__file__))
STEPS = 50
ROUTED_PER_FORWARD = 10  # SD1.5 at 512 px: 5 self-attentions at L=4096 + 5 at L=1024
KERNEL_SHAPES = [  # (B, H, L, d), dtype: the 8-row bucket CFG-doubled, and others
    ((16, 8, 4096, 40), "bfloat16"),
    ((16, 8, 1024, 80), "bfloat16"),
    ((2, 10, 1024, 64), "bfloat16"),
    ((2, 8, 1024, 128), "bfloat16"),
    ((2, 8, 4096, 40), "float32"),
]
BWD_SHAPES = [  # (B, H, L, d), dtype: the grad pass at batch 1 and 2, FLUX's d, one f32
    ((1, 8, 4096, 40), "bfloat16"),
    ((1, 8, 1024, 80), "bfloat16"),
    ((2, 8, 4096, 40), "bfloat16"),
    ((1, 24, 4096, 128), "bfloat16"),
    ((1, 8, 4096, 40), "float32"),
]
TRAIN_ITERATIONS = 6  # the full-width run; per_steps and state_checkpoint_every 3


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def median_ms(fn, runs: int = 10) -> float:
    """Median over `runs` launches, each timed with CUDA events between
    torch.cuda.synchronize() calls, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bf16_tolerance(ref_max: float) -> float:
    """Four bf16 ulps at the output's largest magnitude. The kernel and the
    plain version round p and o to bf16 at the same points but sum in other
    orders (and use the fast exp), so an element may land one or two ulps
    away; four leaves room for a rounding flip of p to carry through P.V."""
    return 4.0 * 2.0 ** (math.floor(math.log2(max(ref_max, 2.0**-20))) - 7)


F32_TOL = 1e-5  # f32 sums in another order; errors seen are ~2e-7


def phase_device():
    import torch

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    from sliders_tpu_torch.ops import sd_attention as sa

    nvcc = subprocess.run([sa._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    say("device", f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"nvcc {nvcc}")


def phase_build():
    from sliders_tpu_torch.ops import sd_attention as sa

    t0 = time.perf_counter()
    libs = sa.build_libraries()
    secs = time.perf_counter() - t0
    for name, lib in libs.items():
        log = lib.with_suffix(".log").read_text().splitlines()
        regs = [f"{kernel} {ln.split('info    : ')[-1]}" for kernel in
                ("attn_fwd_bf16", "attn_bwd_dq_bf16", "attn_bwd_dkdv_bf16")
                for i, ln in enumerate(log)
                if "Used" in ln and i > 1 and f"{kernel}ILi48E" in log[i - 2]]
        say("build", f"{lib.name} (d<=48: {'; '.join(regs) or '?'})")
        sa._library(name)
    say("build", f"both libraries built and loaded in {secs:.1f} s")


def phase_kernel():
    import torch

    from sliders_tpu_torch.ops import sd_attention as sa

    # the comparison is full f32 on both sides: no TF32 in matmuls or convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for shape, dt in KERNEL_SHAPES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
        out = sa.sd_attention(q, k, v)
        ref = sa.sd_attention_ref(q, k, v)
        ref32 = sa.sd_attention_ref(q.float(), k.float(), v.float())
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        err32 = (out.float() - ref32).abs().max().item()
        ref_max = ref.float().abs().max().item()
        del ref32
        tol = bf16_tolerance(ref_max) if dtype == torch.bfloat16 else F32_TOL
        ms = median_ms(lambda: sa.sd_attention(q, k, v))
        plain_ms = median_ms(lambda: sa.sd_attention_ref(q, k, v))
        say("kernel", f"{shape} {dt}: max|err| vs plain {err:.3g} (tol {tol:.3g}), vs f32 "
            f"{err32:.3g}, max|ref| {ref_max:.3g}; median kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms")
        if not (err <= tol and err32 <= 4 * tol):
            raise AssertionError(f"sd_attention disagrees with its plain version at {shape} {dt}")
        results.append({"shape": shape, "dtype": dt, "err": err, "ms": ms, "plain_ms": plain_ms})
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    return results


def bf16_ulp(ref_max: float) -> float:
    return 2.0 ** (math.floor(math.log2(max(ref_max, 2.0**-30))) - 7)


def phase_kernel_bwd():
    """The backward kernel against sd_attention_bwd_ref at the grad-pass
    shapes. bf16: both round p and ds at the same points and differ in
    summation order and the fast exp, held to 4 bf16 ulps at each output's
    largest magnitude; f32: 1e-5 relative to the largest value."""
    import torch

    from sliders_tpu_torch.ops import sd_attention as sa

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4)
    results = []
    for shape, dt in BWD_SHAPES:
        dtype = getattr(torch, dt)
        q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4))
        out = sa.sd_attention_bwd(q, k, v, g)
        ref = sa.sd_attention_bwd_ref(q, k, v, g)
        torch.cuda.synchronize()
        errs, worst, ok = [], 0.0, True
        for name, o, r in zip(("dq", "dk", "dv"), out, ref):
            ref_max = r.float().abs().max().item()
            err = (o.float() - r.float()).abs().max().item()
            tol = 4 * bf16_ulp(ref_max) if dtype == torch.bfloat16 else 1e-5 * max(1.0, ref_max)
            errs.append(f"{name} {err:.3g} (tol {tol:.3g}, max|ref| {ref_max:.3g})")
            ok = ok and err <= tol and o.dtype == dtype and o.shape == r.shape
            worst = max(worst, err)
        del out, ref
        ms = median_ms(lambda: sa.sd_attention_bwd(q, k, v, g))
        plain_ms = median_ms(lambda: sa.sd_attention_bwd_ref(q, k, v, g), runs=5)
        say("kernel", f"bwd {shape} {dt}: max|err| vs plain {', '.join(errs)}; median kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
        if not ok:
            raise AssertionError(f"sd_attention_bwd disagrees with its plain version at {shape} {dt}")
        results.append({"shape": shape, "dtype": dt, "err": worst, "ms": ms, "plain_ms": plain_ms})
        del q, k, v, g
        torch.cuda.empty_cache()
    return results


def tiny_slice(device: str, trees: dict, clip_cfg, latents, tok):
    """Tiny SD at 256 px (L=1024 at level 0, so the routed path) in f32,
    3 DDIM steps with a slider at scales [-1, 0, 1]; returns the latents."""
    import torch

    from sliders_tpu_torch.diffusion.schedulers import make_sampler, make_schedule
    from sliders_tpu_torch.models import unet2d
    from sliders_tpu_torch.models.params import tree_to
    from sliders_tpu_torch.pipelines import text2image as t2i
    from sliders_tpu_torch.pipelines.encoding import encode_prompts

    m = {k: tree_to(v, device) for k, v in trees.items()}
    cond = encode_prompts(tok, m["clip"], clip_cfg, ["a photo of a person"])
    uncond = encode_prompts(tok, m["clip"], clip_cfg, [""])
    fn = t2i.make_sampling_fn(unet2d.TINY, make_sampler(make_schedule(), "ddim", 3),
                              compute_dtype=torch.float32)
    n = latents.shape[0]
    return fn(m["unet"], latents.to(device), cond.expand(n, -1, -1), uncond.expand(n, -1, -1),
              m["slider"], torch.tensor([-1.0, 0.0, 1.0]), torch.full((n,), 750.0),
              torch.full((n,), 7.5)).cpu()


def phase_tiny_slice(tok_dir: str):
    import torch

    from sliders_tpu_torch.lora.network import create_slider_network
    from sliders_tpu_torch.models import clip_text, unet2d
    from sliders_tpu_torch.ops import sd_attention as sa
    from sliders_tpu_torch.text.tokenizer import ClipTokenizer

    gen = torch.Generator().manual_seed(1)
    tok = ClipTokenizer.from_pretrained(tok_dir)
    clip_cfg = clip_text.ClipTextConfig(
        vocab_size=len(tok.vocab), hidden_size=32, num_layers=2, num_heads=2,
        intermediate_size=64, max_positions=16, eos_token_id=tok.eos_token_id,
    )
    tok.model_max_length = clip_cfg.max_positions
    unet = unet2d.init_params(gen, unet2d.TINY)
    slider = create_slider_network(gen, unet, rank=4, train_method="noxattn")
    for e in slider.values():
        e["up"] = torch.randn(e["up"].shape, generator=gen) * 0.1
    trees = {"unet": unet, "clip": clip_text.init_params(gen, clip_cfg), "slider": slider}
    latents = torch.randn((3, 32, 32, 4), generator=gen)
    before = sa.sd_attention.launches
    gpu = tiny_slice("cuda", trees, clip_cfg, latents, tok)
    launched = sa.sd_attention.launches - before
    cpu = tiny_slice("cpu", trees, clip_cfg, latents, tok)
    err = (gpu - cpu).abs().max().item()
    scale = cpu.abs().max().item()
    say("kernel", f"tiny slice 256 px f32, GPU (kernel, {launched} launches) vs CPU (plain): "
        f"max|err| {err:.3g}, max|latent| {scale:.3g}")
    if launched == 0 or not torch.isfinite(gpu).all() or err > 1e-3 * max(1.0, scale):
        raise AssertionError("the tiny slice on the GPU disagrees with the CPU")


TINY_LR = 1e-4


def tiny_train(device: str, unet: dict, lora: dict, pairs: dict, draws: list):
    """TINY at 256 px (L=1024 at level 0, so the routed path) in f32 with
    remat: len(draws) train steps with the given draws; returns the losses,
    the grad norms and the final LoRA on the CPU."""
    import torch

    from sliders_tpu_torch.diffusion.schedulers import make_sampler, make_schedule
    from sliders_tpu_torch.lora.network import trainable_mask
    from sliders_tpu_torch.models import unet2d
    from sliders_tpu_torch.models.params import tree_to
    from sliders_tpu_torch.training import optimizers, text_slider

    sched = make_schedule()
    tx = optimizers.make_optimizer("adamw", optimizers.make_lr_schedule("constant", TINY_LR, 100),
                                   trainable_mask=trainable_mask(lora))
    step = text_slider.make_text_slider_step(
        unet2d.TINY, sched, make_sampler(sched, "ddim", 5), tx, max_denoising_steps=5,
        resolution=256, compute_dtype=torch.float32, remat=True)
    state = text_slider.SliderTrainState.create(0, tree_to(lora, device), tx)
    params = tree_to(unet, device)
    on_device = {k: v.to(device) for k, v in pairs.items()}
    losses, norms = [], []
    for d in draws:
        state, m = step(state, params, on_device, draws=d)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    return losses, norms, {m: {k: t.cpu() for k, t in e.items()} for m, e in state.lora.items()}


def phase_tiny_train():
    """Three tiny train steps on the GPU (both kernels, remat) against the
    CPU (plain paths) with the same draws, in f32 with TF32 off. The two
    differ only by f32 sums in other orders, so each step's loss is held to
    1e-5 relative, its grad norm to 1e-4 relative (a wrong gradient path, say
    swapped dk/dv or a LoRA factor with no gradient, moves it far more), and
    the LoRA after the last update to 1e-6 absolute (Adam moves an element
    about lr = 1e-4 a step, so a sign flip of a gradient shows)."""
    import torch

    from sliders_tpu_torch.lora.network import create_slider_network
    from sliders_tpu_torch.models import unet2d
    from sliders_tpu_torch.ops import sd_attention as sa
    from sliders_tpu_torch.training.text_slider import step_draws

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(6)
    unet = unet2d.init_params(gen, unet2d.TINY)
    lora = create_slider_network(gen, unet, rank=4, train_method="noxattn")
    pairs = {k: torch.randn((1, 8, 32), generator=gen)
             for k in ("target", "positive", "neutral", "unconditional")}
    pairs["guidance_signed"] = torch.tensor([2.0])
    draws = [step_draws(6, i, 1, 5, (1, 32, 32, 4), 1.0) for i in range(3)]
    fwd0, bwd0 = sa.sd_attention.launches, sa.sd_attention_bwd.launches
    gpu_losses, gpu_norms, gpu_lora = tiny_train("cuda", unet, lora, pairs, draws)
    fwd, bwd = sa.sd_attention.launches - fwd0, sa.sd_attention_bwd.launches - bwd0
    cpu_losses, cpu_norms, cpu_lora = tiny_train("cpu", unet, lora, pairs, draws)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(gpu_losses, cpu_losses))
    norm_err = max(abs(a - b) / abs(b) for a, b in zip(gpu_norms, cpu_norms))
    lora_err = max((gpu_lora[m][k] - cpu_lora[m][k]).abs().max().item()
                   for m in cpu_lora for k in ("down", "up"))
    say("kernel", f"tiny training 256 px f32, 3 steps (t_to {[d[1] for d in draws]}), GPU "
        f"(kernels: {fwd} forward, {bwd} backward launches) vs CPU (plain): losses "
        f"{[f'{x:.6g}' for x in gpu_losses]} vs {[f'{x:.6g}' for x in cpu_losses]}, max rel err "
        f"{loss_err:.3g} (tol 1e-5); grad norms {[f'{x:.6g}' for x in gpu_norms]} vs "
        f"{[f'{x:.6g}' for x in cpu_norms]}, max rel err {norm_err:.3g} (tol 1e-4); LoRA "
        f"max|err| {lora_err:.3g} (tol 1e-6)")
    if fwd == 0 or bwd == 0 or not (loss_err <= 1e-5 and norm_err <= 1e-4 and lora_err <= 1e-6):
        raise AssertionError("tiny training on the GPU disagrees with the CPU")


def write_tokenizer(d: str) -> None:
    """A small synthetic CLIP BPE vocabulary (no tokenizer files ship with
    random weights); any token id it yields is valid for CLIP-L."""
    chars = list("abcdefghijklmnopqrstuvwxyz0123456789!,.")
    vocab = {}
    for c in chars:
        vocab.setdefault(c, len(vocab))
        vocab.setdefault(c + "</w>", len(vocab))
    merges = [("o", "l"), ("ol", "d</w>"), ("p", "e"), ("pe", "r"), ("s", "o")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))


def build_engine(tok_dir: str):
    import torch

    from sliders_tpu_torch.lora.network import create_slider_network
    from sliders_tpu_torch.models import clip_text, unet2d, vae
    from sliders_tpu_torch.models.loader import SDModels, TextEncoderBundle
    from sliders_tpu_torch.serving.server import SliderEngine
    from sliders_tpu_torch.text.tokenizer import ClipTokenizer

    # the engine as served: cuDNN convs may use TF32 (the VAE decodes in f32),
    # matmuls stay full f32; both set explicitly
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    tok = ClipTokenizer.from_pretrained(tok_dir)
    tok.model_max_length = clip_text.CLIP_L.max_positions
    unet = unet2d.init_params(gen, unet2d.SD15, dtype=torch.bfloat16, device="cuda")
    models = SDModels(
        unet, unet2d.SD15,
        [TextEncoderBundle(tok, clip_text.init_params(gen, clip_text.CLIP_L, device="cuda"),
                           clip_text.CLIP_L)],
        vae_params=vae.init_params(gen, vae.SD_VAE, dtype=torch.bfloat16, device="cuda"),
        vae_config=vae.SD_VAE,
    )
    n_params = sum(t.numel() for t in _leaves(unet))
    engine = SliderEngine(models, device="cuda", steps=STEPS, image_size=512,
                          guidance_scale=7.5, start_noise=750.0, compute_dtype=torch.bfloat16)
    for name in ("s1", "s2"):
        w = create_slider_network(gen, unet, rank=4, alpha=1.0, train_method="noxattn",
                                  device="cuda")
        for e in w.values():  # nonzero up, so the scale changes the image
            e["up"] = torch.randn(e["up"].shape, generator=gen, device="cuda") * 0.05
        engine.register_slider(name, w)
    torch.cuda.synchronize()
    say("engine", f"SD1.5 UNet {n_params / 1e6:.1f} M params + CLIP-L + SD VAE on "
        f"{engine.device}, bf16, 512 px, DDIM {STEPS}, 2 rank-4 noxattn sliders "
        f"({len(w)} modules each): built in {time.perf_counter() - t0:.1f} s")
    return engine


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _kernel_class(name: str) -> str:
    n = name.lower()
    for key, cls in (("attn_fwd", "attention kernel"), ("conv", "conv"), ("fprop", "conv"),
                     ("gemm", "gemm"), ("xmma", "gemm"), ("cutlass", "gemm"),
                     ("reduce", "reduction"), ("elementwise", "elementwise")):
        if key in n:
            return cls
    return "other"


def phase_step(engine):
    """Where a denoise step goes: one UNet forward of the 8-row bucket
    (16 rows CFG-doubled) with a slider, timed through the kernel and on the
    plain attention path, then profiled by kernel class; and one VAE decode
    of 8 rows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sliders_tpu_torch.models import unet2d
    from sliders_tpu_torch.ops import attention as ta
    from sliders_tpu_torch.ops.basic import SliderLora
    from sliders_tpu_torch.pipelines.text2image import decode_images

    m = engine.models
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((16, 64, 64, 4), generator=gen, device="cuda").bfloat16()
    ctx = torch.randn((16, 77, 768), generator=gen, device="cuda").bfloat16()
    lora = SliderLora(engine.sliders["s1"], torch.linspace(-2, 2, 16, device="cuda"))
    t = torch.tensor(501.0, device="cuda")

    def step():
        with torch.inference_mode():
            unet2d.apply(m.unet_params, m.unet_config, x, t, ctx, lora=lora)

    kernel_ms = median_ms(step)
    ta.set_attention_impl("xla")  # every attention on the plain path
    try:
        plain_ms = median_ms(step)
    finally:
        ta.set_attention_impl("auto")
    say("step", f"UNet forward, 16 rows (bucket 8 CFG-doubled), 512 px, bf16, slider on: "
        f"median {kernel_ms:.2f} ms through the kernel, {plain_ms:.2f} ms on the plain "
        f"attention path")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_class: dict = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            cls = _kernel_class(e.key)
            by_class[cls] = by_class.get(cls, 0.0) + e.device_time_total / 1e3
    busy = sum(by_class.values())
    say("step", "device ms per step by kernel class: " + ", ".join(
        f"{cls} {ms / 3:.2f} ({ms / busy * 100:.1f}%)"
        for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]))
        + f"; idle share {(1 - busy / wall) * 100:.1f}% (profiler on, 3 steps)")

    lat = torch.randn((8, 64, 64, 4), generator=gen, device="cuda")
    dec_ms = median_ms(lambda: decode_images(m.vae_params, m.vae_config, lat), runs=3)
    say("step", f"VAE decode of 8 images (f32, cuDNN TF32 allowed): median {dec_ms:.2f} ms; "
        f"peak device memory so far {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")


def phase_grad_ab(engine, rounds: int = 4, passes: int = 5):
    """The training grad pass at full width (SD1.5 UNet bf16, batch 1,
    512 px, remat, the rank-4 slider's factors as the leaves) through the
    kernel route (both kernels) against the plain attention route ('xla'),
    in alternating order; per round the median of `passes` synced passes,
    the host's enqueue time, the working memory above what was allocated
    before, and the grad norm, which must agree between the routes within
    1e-2 relative (bf16 through the whole UNet, and the plain route's
    autograd rounds dp where the kernel rounds ds). The kernels' correctness
    is held tightly elsewhere; this phase measures the routes."""
    import torch

    from sliders_tpu_torch.models import unet2d
    from sliders_tpu_torch.ops import attention as ta
    from sliders_tpu_torch.ops import sd_attention as sa
    from sliders_tpu_torch.ops.basic import SliderLora

    m = engine.models
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((1, 64, 64, 4), generator=gen, device="cuda").bfloat16()
    ctx = torch.randn((1, 77, 768), generator=gen, device="cuda").bfloat16()
    t = torch.tensor(501.0, device="cuda")
    slider = engine.sliders["s1"]

    def grad_pass():
        leaves = {n: {k: (v.detach().float().requires_grad_() if k != "alpha" else v)
                      for k, v in e.items()} for n, e in slider.items()}
        eps = unet2d.apply(m.unet_params, m.unet_config, x, t, ctx,
                           lora=SliderLora(leaves, 1.0), remat=True)
        params = [e[k] for e in leaves.values() for k in ("down", "up")]
        return torch.autograd.grad((eps.float() ** 2).mean(), params)

    def run(impl):
        ta.set_attention_impl(impl)
        try:
            grad_pass()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            b0 = sa.sd_attention_bwd.launches
            dev, host = [], []
            for _ in range(passes):
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                h0 = time.perf_counter()
                s.record()
                grads = grad_pass()
                h1 = time.perf_counter()
                e.record()
                torch.cuda.synchronize()
                dev.append(s.elapsed_time(e))
                host.append((h1 - h0) * 1e3)
            norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads)).item()
            return {"ms": statistics.median(dev), "host_ms": statistics.median(host),
                    "work_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
                    "bwd_per_pass": (sa.sd_attention_bwd.launches - b0) / passes, "norm": norm}
        finally:
            ta.set_attention_impl("auto")

    out = {"auto": [], "xla": []}
    for r in range(rounds):
        for impl in (("auto", "xla") if r % 2 == 0 else ("xla", "auto")):
            out[impl].append(run(impl))
    for impl, name in (("auto", "kernel route"), ("xla", "plain route")):
        rs = out[impl]
        say("grad", f"{name}: ms per pass by round {[round(r['ms'], 2) for r in rs]} (median "
            f"{statistics.median(r['ms'] for r in rs):.2f}); host enqueue "
            f"{[round(r['host_ms'], 2) for r in rs]}; working memory "
            f"{max(r['work_gb'] for r in rs):.2f} GB; backward-kernel launches per pass "
            f"{rs[0]['bwd_per_pass']:g}; grad norm {rs[0]['norm']:.6g}")
    k_norm, p_norm = out["auto"][0]["norm"], out["xla"][0]["norm"]
    if out["auto"][0]["bwd_per_pass"] != ROUTED_PER_FORWARD or out["xla"][0]["bwd_per_pass"] != 0:
        raise AssertionError("the grad pass did not take the route it was given")
    if not (math.isfinite(k_norm) and abs(k_norm - p_norm) <= 1e-2 * abs(p_norm)):
        raise AssertionError(f"grad norms disagree between the routes: {k_norm} vs {p_norm}")


def png_pixels(png: bytes):
    """Decode one of the engine's PNGs (8-bit RGB, filter 0): returns
    (width, height, pixel bytes) after checking the signature and CRCs."""
    if png[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    pos, chunks = 8, {}
    while pos < len(png):
        (n,) = struct.unpack(">I", png[pos:pos + 4])
        tag, data = png[pos + 4:pos + 8], png[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", png[pos + 8 + n:pos + 12 + n])
        if crc != zlib.crc32(tag + data) & 0xFFFFFFFF:
            raise AssertionError(f"bad CRC in PNG chunk {tag!r}")
        chunks.setdefault(tag, b"")
        chunks[tag] += data
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    if (depth, color) != (8, 2):
        raise AssertionError(f"PNG is not 8-bit RGB: depth {depth} color {color}")
    raw = zlib.decompress(chunks[b"IDAT"])
    stride = 1 + 3 * w
    if len(raw) != h * stride or any(raw[r * stride] for r in range(h)):
        raise AssertionError("unexpected PNG scanline layout")
    return w, h, b"".join(raw[r * stride + 1:(r + 1) * stride] for r in range(h))


def post(port: int, path: str, payload: dict) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=900) as r:
        if r.status != 200:
            raise AssertionError(f"{path} answered {r.status}")
        return json.loads(r.read())


def check_images(reply: dict, scales: list, tag: str) -> list:
    imgs = reply["images"]
    if [im["scale"] for im in imgs] != [float(s) for s in scales]:
        raise AssertionError(f"{tag}: scales {[im['scale'] for im in imgs]} != {scales}")
    pixels = []
    for im in imgs:
        w, h, px = png_pixels(base64.b64decode(im["png"]))
        if (w, h) != (512, 512):
            raise AssertionError(f"{tag}: image is {w}x{h}, not 512x512")
        if px.count(px[:1]) == len(px):
            raise AssertionError(f"{tag}: image at scale {im['scale']} is one flat value")
        pixels.append(px)
    return pixels


def phase_http(engine):
    from sliders_tpu_torch.ops import sd_attention as sa
    from sliders_tpu_torch.serving.server import make_http_server

    server = make_http_server(engine, "127.0.0.1", 0)
    port = server.server_address[1]
    serve = threading.Thread(target=server.serve_forever, daemon=True)
    serve.start()
    try:
        t0 = time.perf_counter()
        engine.warmup(with_slider="s1")
        say("http", f"warmup (5 scales -> bucket 8, one denoise) {time.perf_counter() - t0:.2f} s")

        stats0 = dict(engine.stats)
        sa.sd_attention.launches = 0  # count only the served requests from here
        replies = {}

        def call(key, payload):
            t = time.perf_counter()
            replies[key] = (post(port, "/generate", payload), time.perf_counter() - t)

        scales_a = [-2, -1, 0, 1, 2]
        ta = threading.Thread(target=call, args=("a", {
            "prompt": "a photo of a person", "seed": 1, "slider": "s1", "scales": scales_a}))
        ta.start()
        # (b) is sent once (a) is denoising (its first kernel launch), so both
        # (b) requests wait in the queue together and the worker coalesces
        # them into one stacked batch of 4
        deadline = time.monotonic() + 600
        while sa.sd_attention.launches == 0:
            if time.monotonic() > deadline or not ta.is_alive():
                raise AssertionError("request (a) never started denoising")
            time.sleep(0.005)
        tb = [threading.Thread(target=call, args=(f"b{i}", {
            "prompt": "a photo of a person", "seed": 2 + i, "slider": f"s{i + 1}",
            "scales": [-1.5, 1.5]})) for i in range(2)]
        t_b = time.perf_counter()
        for t in tb:
            t.start()
        while len(engine._queue) < 2:
            if engine.stats["batches"] != stats0["batches"]:
                raise AssertionError("request (a) finished before both (b) requests were queued")
            time.sleep(0.005)
        say("http", f"both (b) requests queued behind (a) after "
            f"{(time.perf_counter() - t_b) * 1e3:.1f} ms")
        for t in [ta, *tb]:
            t.join(timeout=900)
            if t.is_alive():
                raise AssertionError("a /generate call did not return")
        for key in ("a", "b0", "b1"):
            if key not in replies:
                raise AssertionError(f"request {key} failed")

        px_a = check_images(replies["a"][0], scales_a, "a")
        if px_a[0] == px_a[-1]:
            raise AssertionError("the -2 and +2 images are identical: the slider did nothing")
        check_images(replies["b0"][0], [-1.5, 1.5], "b0")
        check_images(replies["b1"][0], [-1.5, 1.5], "b1")

        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if r.status != 200 or not health["ok"] or health["sliders"] != ["s1", "s2"]:
            raise AssertionError(f"/healthz answered {r.status}: {health}")

        batches = engine.stats["batches"] - stats0["batches"]
        rows = engine.stats["rows"] - stats0["rows"]
        launches = sa.sd_attention.launches
        expected = ROUTED_PER_FORWARD * STEPS * batches
        for key in ("a", "b0", "b1"):
            reply, wall = replies[key]
            say("http", f"/generate {key}: {len(reply['images'])} images, server latency "
                f"{reply['latency_ms']} ms, client {wall * 1e3:.1f} ms")
        say("http", "every image 512x512 and not flat; -2 and +2 differ; latents finite "
            "(the engine refuses non-finite latents before decoding)")
        say("http", f"/healthz ok; engine stats {health['stats']}; denoise batches for the "
            f"3 requests: {batches} ({rows} rows); kernel launches {launches}, expected "
            f"{ROUTED_PER_FORWARD} x {STEPS} x {batches} = {expected}")
        if batches != 2 or rows != 9:
            raise AssertionError("the two (b) requests were not coalesced into one batch")
        if launches != expected:
            raise AssertionError("not every routed self-attention went through the kernel")
        return launches
    finally:
        server.shutdown()
        server.server_close()
        engine.close(timeout=60)


def unet_hf_config(cfg) -> dict:
    """The diffusers unet/config.json of a UNetConfig (SD1 keys)."""
    return {
        "in_channels": cfg.in_channels, "out_channels": cfg.out_channels,
        "block_out_channels": list(cfg.block_out_channels),
        "down_block_types": list(cfg.down_block_types),
        "up_block_types": list(cfg.up_block_types), "layers_per_block": cfg.layers_per_block,
        "cross_attention_dim": cfg.cross_attention_dim,
        "attention_head_dim": list(cfg.num_attention_heads),
        "transformer_layers_per_block": list(cfg.transformer_layers_per_block),
        "use_linear_projection": cfg.use_linear_projection,
        "norm_num_groups": cfg.norm_num_groups,
    }


def write_sd15_snapshot(root: str) -> int:
    """A diffusers-layout SD1.5 snapshot with seeded random weights: the UNet
    in bf16, CLIP-L in f32, the synthetic tokenizer, and no VAE (training
    needs none). Returns the UNet's parameter count."""
    import torch

    from sliders_tpu_torch.models import clip_text, unet2d
    from sliders_tpu_torch.models.convert import write_safetensors
    from sliders_tpu_torch.utils.pytree import flatten

    for sub in ("unet", "text_encoder", "tokenizer"):
        os.makedirs(os.path.join(root, sub))
    write_tokenizer(os.path.join(root, "tokenizer"))
    with open(os.path.join(root, "tokenizer", "vocab.json")) as f:
        eos = json.load(f)["<|endoftext|>"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    unet = flatten(unet2d.init_params(gen, unet2d.SD15, dtype=torch.bfloat16, device="cuda"))
    n_params = sum(t.numel() for t in unet.values())
    write_safetensors(os.path.join(root, "unet", "diffusion_pytorch_model.safetensors"), unet)
    with open(os.path.join(root, "unet", "config.json"), "w") as f:
        json.dump(unet_hf_config(unet2d.SD15), f)
    del unet
    cfg = clip_text.CLIP_L
    clip = flatten(clip_text.init_params(gen, cfg, device="cuda"))
    write_safetensors(os.path.join(root, "text_encoder", "model.safetensors"), clip)
    with open(os.path.join(root, "text_encoder", "config.json"), "w") as f:
        json.dump({"vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
                   "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
                   "intermediate_size": cfg.intermediate_size,
                   "max_position_embeddings": cfg.max_positions, "hidden_act": cfg.hidden_act,
                   "eos_token_id": eos}, f)
    return n_params


def dump_yaml(tree: dict, indent: int = 0) -> str:
    """Nested mappings of scalars as YAML (strings double-quoted)."""
    lines = []
    for k, v in tree.items():
        if isinstance(v, dict):
            lines.append(" " * indent + f"{k}:")
            lines.append(dump_yaml(v, indent + 2))
        elif isinstance(v, bool) or v is None:
            lines.append(" " * indent + f"{k}: {json.dumps(v)}")  # true / false / null
        else:
            text = json.dumps(v) if isinstance(v, str) else repr(v)
            lines.append(" " * indent + f"{k}: {text}")
    return "\n".join(lines)


def run_training(cfg: dict, path: str, extra: list) -> dict:
    """The training CLI in-process on cuda:0 with the config `cfg` (written
    to `path`); the kernels' counts are set to 0 just before and read just
    after. Returns the per-iteration records, the counts and the LoRA."""
    import torch

    from sliders_tpu_torch.cli import train_text_slider as cli
    from sliders_tpu_torch.ops import sd_attention as sa

    with open(path, "w") as f:
        f.write(dump_yaml(cfg) + "\n")
    records = []
    torch.cuda.reset_peak_memory_stats()
    sa.sd_attention.launches = sa.sd_attention_bwd.launches = 0
    t0 = time.perf_counter()
    final = cli.main(cli.build_parser().parse_args(["--config_file", path, "--device", "0",
                                                    *extra]),
                     on_step=lambda i, state, m: records.append((i, time.perf_counter(), m)))
    torch.cuda.synchronize()
    return {"records": records, "fwd": sa.sd_attention.launches, "bwd": sa.sd_attention_bwd.launches,
            "lora": final, "seconds": time.perf_counter() - t0,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def expected_fwd(records, remat: bool) -> int:
    """Forward-kernel launches of the iterations: 10 routed self-attentions
    per UNet call, t_to calls in the partial denoise, one frozen pass, the
    grad pass, and with remat the grad pass's forward again in the backward."""
    return sum(ROUTED_PER_FORWARD * (m["t_to"] + 2 + int(remat)) for _, _, m in records)


def phase_train():
    """SD1.5 at full width through the training CLI, then a resume."""
    import torch

    from sliders_tpu_torch.core import yaml_subset
    from sliders_tpu_torch.lora import io as lora_io
    from sliders_tpu_torch.models import unet2d

    with tempfile.TemporaryDirectory() as tmp:
        snap = os.path.join(tmp, "sd15")
        t0 = time.perf_counter()
        n_params = write_sd15_snapshot(snap)
        say("train", f"SD1.5 snapshot with random weights (UNet {n_params / 1e6:.1f} M params "
            f"bf16, CLIP-L f32, no VAE) written in {time.perf_counter() - t0:.1f} s")

        cfg = yaml_subset.load(os.path.join(REPO, "data", "config.yaml"))
        overrides = {
            ("prompts_file",): os.path.join(REPO, "data", "prompts.yaml"),
            ("pretrained_model", "name_or_path"): snap,
            ("train", "iterations"): TRAIN_ITERATIONS,
            ("save", "path"): os.path.join(tmp, "out"),
            ("save", "per_steps"): 3,
            ("logging", "log_every"): 1,
            ("tpu", "state_checkpoint_every"): 3,
        }
        for keys, value in overrides.items():
            node = cfg
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = value
        say("train", f"config data/config.yaml: train {cfg['train']}; network {cfg['network']}; "
            f"tpu {cfg['tpu']}; overridden: iterations, save.per_steps, logging.log_every, "
            f"tpu.state_checkpoint_every and the paths (prompts: data/prompts.yaml)")
        remat = bool(cfg["tpu"]["remat"])

        run = run_training(cfg, os.path.join(tmp, "config.yaml"), [])
        recs = run["records"]
        losses = [m["loss"] for _, _, m in recs]
        t_tos = [m["t_to"] for _, _, m in recs]
        fwd_expected = expected_fwd(recs, remat)
        bwd_expected = ROUTED_PER_FORWARD * TRAIN_ITERATIONS
        say("train", f"{len(recs)} iterations: t_to {t_tos}, losses "
            f"{[f'{x:.6g}' for x in losses]}; kernel launches: forward {run['fwd']} (expected "
            f"{fwd_expected} = 10 x sum(t_to + 2 + remat)), backward {run['bwd']} (expected "
            f"{bwd_expected} = 10 x {TRAIN_ITERATIONS})")
        if [i for i, _, _ in recs] != list(range(TRAIN_ITERATIONS)):
            raise AssertionError("the run did not take every iteration")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError("a training loss is not finite")
        if run["fwd"] != fwd_expected or run["bwd"] != bwd_expected:
            raise AssertionError("not every routed self-attention of the training run went "
                                 "through the kernels")

        final = run["lora"]
        frozen_up = [m for m, e in final.items() if not bool(e["up"].abs().max() > 0)]
        if frozen_up:
            raise AssertionError(f"{len(frozen_up)} LoRA up factors never moved from zero, e.g. "
                                 f"{frozen_up[:3]}")
        if any(e["alpha"].item() != cfg["network"]["alpha"] for e in final.values()):
            raise AssertionError("a LoRA alpha changed")
        name = (f"{cfg['save']['name']}_alpha{float(cfg['network']['alpha'])}"
                f"_rank{cfg['network']['rank']}_{cfg['network']['training_method']}")
        out_dir = os.path.join(tmp, "out", name)
        files = sorted(os.listdir(out_dir))
        expected_files = sorted(f"{name}{s}" for s in ("_3steps.safetensors", "_last.safetensors",
                                                       "_metadata.json", "_trainstate.pt"))
        if files != expected_files:
            raise AssertionError(f"saved files {files}, expected {expected_files}")
        meta_unet = unet2d.init_params(None, unet2d.SD15, device="meta")
        last = lora_io.load_slider(os.path.join(out_dir, f"{name}_last.safetensors"), meta_unet)
        if set(last) != set(final) or any(not torch.equal(last[m][k], final[m][k])
                                          for m in final for k in ("down", "up", "alpha")):
            raise AssertionError("the _last slider does not reload equal to the trained LoRA")
        say("train", f"{len(final)} LoRA modules: every up factor moved from zero, every alpha "
            f"still {cfg['network']['alpha']}; files {files}; _last reloads equal")

        # resume from the state saved after step 3 for one more iteration
        cfg["train"]["iterations"] = 5
        resumed = run_training(cfg, os.path.join(tmp, "config_resume.yaml"),
                               ["--resume", os.path.join(out_dir, f"{name}_trainstate.pt")])
        rrecs = resumed["records"]
        if [i for i, _, _ in rrecs] != [4]:
            raise AssertionError(f"the resumed run took steps {[i for i, _, _ in rrecs]}, not [4]")
        m4, r4 = recs[4][2], rrecs[0][2]
        rel = abs(r4["loss"] - m4["loss"]) / abs(m4["loss"])
        r_fwd = expected_fwd(rrecs, remat)
        say("train", f"resume at step 4: t_to {r4['t_to']} pair {r4['pair']} (first run "
            f"{m4['t_to']}, {m4['pair']}), loss {r4['loss']:.6g} vs {m4['loss']:.6g} (rel "
            f"{rel:.3g}); launches forward {resumed['fwd']} (expected {r_fwd}), backward "
            f"{resumed['bwd']} (expected {ROUTED_PER_FORWARD})")
        if (r4["t_to"], r4["pair"]) != (m4["t_to"], m4["pair"]) or rel > 1e-3:
            raise AssertionError("the resumed step does not repeat the first run's step 4")
        if resumed["fwd"] != r_fwd or resumed["bwd"] != ROUTED_PER_FORWARD:
            raise AssertionError("the resumed run did not go through the kernels")

    # time per iteration, past the first (which includes cuBLAS/cuDNN set-up)
    steady = recs[1:]
    host_s = [b[1] - a[1] for a, b in zip(recs, recs[1:])]
    phases = {k: statistics.median(m["phase_ms"][k] for _, _, m in steady)
              for k in ("denoise", "frozen", "grad", "update")}
    per_call = statistics.median(m["phase_ms"]["denoise"] / m["t_to"] for _, _, m in steady)
    say("train", f"median per iteration (iterations 1-{len(recs) - 1}): "
        f"{statistics.median(host_s):.3f} s host wall; device ms: denoise loop "
        f"{phases['denoise']:.1f} ({per_call:.2f} per CFG-doubled UNet call), frozen pass "
        f"{phases['frozen']:.2f}, grad pass forward + backward {phases['grad']:.2f}, update "
        f"{phases['update']:.2f}; peak device memory {run['peak_gb']:.2f} GB; whole run "
        f"{run['seconds']:.1f} s including the load")
    return {"fwd": run["fwd"], "bwd": run["bwd"], "resume_fwd": resumed["fwd"],
            "resume_bwd": resumed["bwd"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import sliders_tpu_torch

    if not os.path.abspath(sliders_tpu_torch.__file__).startswith(REPO + os.sep):
        print(f"chip_smoke: sliders_tpu_torch imported from outside {REPO}", file=sys.stderr)
        return 1
    phase_device()
    phase_build()
    results = phase_kernel()
    bwd_results = phase_kernel_bwd()
    with tempfile.TemporaryDirectory() as tok_dir:
        write_tokenizer(tok_dir)
        phase_tiny_slice(tok_dir)
        phase_tiny_train()
        engine = build_engine(tok_dir)
    phase_step(engine)
    phase_grad_ab(engine)
    serve_launches = phase_http(engine)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train()

    # launches: this slice's main path (training); the serving path's count
    # and the resume's are listed beside it
    level0, bwd_level0 = results[0], bwd_results[0]
    print(json.dumps({"kernels": [{
        "name": "sd_attention_fwd",
        "route": "cuda",
        "source": "sliders_tpu_torch/csrc/sd_attention.cu",
        "replaces": "sliders_tpu/ops/pallas_attention.py:43",
        "launches": train["fwd"],
        "launches_by_path": {"train": train["fwd"], "train_resume": train["resume_fwd"],
                             "serve": serve_launches},
        "max_abs_err": max(r["err"] for r in results),
        "ms": level0["ms"],
        "plain_ms": level0["plain_ms"],
    }, {
        "name": "sd_attention_bwd",
        "route": "cuda",
        "source": "sliders_tpu_torch/csrc/sd_attention_bwd.cu",
        "replaces": "sliders_tpu/ops/pallas_attention.py:156",
        "launches": train["bwd"],
        "launches_by_path": {"train": train["bwd"], "train_resume": train["resume_bwd"]},
        "max_abs_err": max(r["err"] for r in bwd_results),
        "ms": bwd_level0["ms"],
        "plain_ms": bwd_level0["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
