#!/usr/bin/env python3
"""Drive the PyTorch port's SD1.5 slider-serving path once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of the repository

Phases, each printing one line or a few before the last:
  1. device: the card's name and power limit (nvidia-smi), torch/CUDA/nvcc.
  2. build:  nvcc builds sliders_tpu_torch/csrc/sd_attention.cu for sm_90a.
  3. kernel: the attention kernel against its plain PyTorch version at the
     slice's shapes (error and median time of each), then the whole tiny
     slice at 256 px on the GPU (through the kernel) against the CPU (plain
     path) in f32.
  4. engine: an SD1.5 SliderEngine at full width (UNet SD15, CLIP-L, SD VAE,
     512 px, DDIM 50, guidance 7.5, start_noise 750) in bf16 with seeded
     random weights and two rank-4 noxattn sliders, behind the HTTP server;
     one UNet step timed through the kernel and on the plain attention
     path, its device time by kernel class, and one VAE decode.
  5. http:   /generate with five scales, two concurrent /generate calls for
     the two sliders (coalesced into one stacked batch), /healthz; every
     reply is checked, and the kernel's launch count must equal
     10 routed self-attentions x 50 steps x the denoise batches.
The last line is {"ok": true, "device": {...}}; any failure raises, exits
non-zero and prints no such line. It needs a CUDA device and the rest of
the repository beside it.
"""

from __future__ import annotations

import base64
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
    lib = sa.build_library()
    secs = time.perf_counter() - t0
    log = lib.with_suffix(".log").read_text().splitlines()
    regs = [ln.split("info    : ")[-1] for i, ln in enumerate(log)
            if "Used" in ln and i > 0 and "attn_fwd_bf16ILi48E" in log[i - 2]]
    say("build", f"{lib.name} in {secs:.1f} s (bf16 d<=48 kernel: {regs[0] if regs else '?'})")
    sa._library()


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

    from sliders_tpu.text.tokenizer import ClipTokenizer
    from sliders_tpu_torch.lora.network import create_slider_network
    from sliders_tpu_torch.models import clip_text, unet2d
    from sliders_tpu_torch.ops import sd_attention as sa

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

    from sliders_tpu.text.tokenizer import ClipTokenizer
    from sliders_tpu_torch.lora.network import create_slider_network
    from sliders_tpu_torch.models import clip_text, unet2d, vae
    from sliders_tpu_torch.models.loader import SDModels, TextEncoderBundle
    from sliders_tpu_torch.serving.server import SliderEngine

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
    gate = ta.routes_to_sd_kernel
    ta.routes_to_sd_kernel = lambda *args: False  # every attention on the plain path
    try:
        plain_ms = median_ms(step)
    finally:
        ta.routes_to_sd_kernel = gate
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
    with tempfile.TemporaryDirectory() as tok_dir:
        write_tokenizer(tok_dir)
        phase_tiny_slice(tok_dir)
        engine = build_engine(tok_dir)
    phase_step(engine)
    launches = phase_http(engine)

    level0 = results[0]
    print(json.dumps({"kernels": [{
        "name": "sd_attention_fwd",
        "route": "cuda",
        "source": "sliders_tpu_torch/csrc/sd_attention.cu",
        "replaces": "sliders_tpu/ops/pallas_attention.py:43",
        "launches": launches,
        "max_abs_err": max(r["err"] for r in results),
        "ms": level0["ms"],
        "plain_ms": level0["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
