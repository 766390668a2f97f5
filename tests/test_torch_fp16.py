"""`precision: fp16` in the port against the JAX package on the CPU.

The kernels' plain versions in f16 against the JAX package's kernels as its
own CPU tests run them (#1 and #2 in Pallas interpret mode, #5-#7 through
`pallas_conv` in interpret mode, #9's pin, which is the identity off the
TPU); the text step and the text fleet step at `compute_dtype=float16` on
f32 weights against the JAX steps at `jnp.float16` on the JAX draws; and the
FLUX and image CLIs (and the image fleet), which run f32 under fp16 as the
JAX CLIs do (the text CLI's fp16 run is in tests/test_torch_training.py).

Tolerances, stated where used:
- kernels: f16 keeps 11 significant bits, so an ulp at magnitude m is
  2^(floor(log2 m) - 10). Both sides round p, ds and the outputs at the same
  points and sum in f32 in other orders: a rounding may flip, held to 4 f16
  ulps (attention) or 2 (convs, one rounding) at the largest magnitude.
- steps: XLA keeps f16 intermediates in f32 inside its fusions (its
  `xla_allow_excess_precision`, on by default) where the port rounds after
  every op, so a TINY UNet output differs by 3-4 f16 ulps (about as far as
  JAX's own f16 output is from its f32 one). The loss and grad norm are
  held to 1 % (seen: up to 0.24 %). AdamW's first steps move each element
  by about lr whatever its gradient's size, so an element whose f16
  gradient sits near zero may step the other way: every LoRA element is
  held within 2 lr per step, and 97 % of them within lr / 10 (seen: 99 %).
"""

import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers import make_tiny_flux_snapshot, make_tiny_snapshot

from sliders_tpu.diffusion import make_sampler as jmake_sampler
from sliders_tpu.diffusion import make_schedule as jmake_schedule
from sliders_tpu.lora import network as jnet
from sliders_tpu.models import unet2d as junet
from sliders_tpu.ops import basic as jbasic
from sliders_tpu.ops import pallas_attention as pa
from sliders_tpu.ops import pallas_conv as pc
from sliders_tpu.training import fleet as jfleet
from sliders_tpu.training import optimizers as jopt
from sliders_tpu.training import text_slider as jts
from sliders_tpu_torch.cli import train_flux_slider as flux_cli
from sliders_tpu_torch.cli import train_image_slider as image_cli
from sliders_tpu_torch.cli import train_text_slider as text_cli
from sliders_tpu_torch.diffusion import schedulers as tsched
from sliders_tpu_torch.lora import network as tnet
from sliders_tpu_torch.models import loader
from sliders_tpu_torch.models import unet2d as tunet
from sliders_tpu_torch.models.convert import from_jax_params
from sliders_tpu_torch.ops import conv3x3 as tc
from sliders_tpu_torch.ops import layout_pin as tlp
from sliders_tpu_torch.ops import sd_attention as tsa
from sliders_tpu_torch.serving.server import encode_png
from sliders_tpu_torch.training import driver
from sliders_tpu_torch.training import fleet as tfleet
from sliders_tpu_torch.training import optimizers as topt
from sliders_tpu_torch.training import text_slider as tts

MAX_STEPS = 5
LR = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny tensors gain nothing from torch's thread pool, and beside the
    other test workers its threads oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f16_ulps(ref: np.ndarray, n: int) -> float:
    m = max(float(np.abs(ref).max()), 2.0**-14)
    return n * 2.0 ** (math.floor(math.log2(m)) - 10)


def _arrays(shape, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


# ---------------------------------------------------------------------------
# the kernels' plain versions in f16
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 2, 1024, 40), (1, 2, 1024, 64), (1, 2, 1024, 80)])
def test_sd_attention_plain_f16_matches_pallas_interpret(shape):
    """#1: f32 logits and softmax, p rounded to f16 after normalising, P.V
    in f32, o rounded to f16, as the TPU kernel does at f16."""
    q, k, v = _arrays(shape, 3)
    ref = np.asarray(pa.sd_attention(*(jnp.asarray(t, jnp.float16) for t in (q, k, v)), 512,
                                     True), np.float32)
    launches = tsa.sd_attention.launches
    out = tsa.sd_attention(*(torch.from_numpy(t).half() for t in (q, k, v)))
    assert tsa.sd_attention.launches == launches  # CPU tensors never reach the kernel
    assert out.dtype == torch.float16 and tuple(out.shape) == shape
    assert np.abs(out.float().numpy() - ref).max() <= _f16_ulps(ref, 4)


@pytest.mark.parametrize("shape", [(1, 2, 256, 40), (1, 2, 256, 64), (1, 2, 256, 80)])
def test_sd_attention_bwd_plain_f16_matches_pallas_interpret(shape):
    """#2: dv from round(p), ds rounded to f16, products in f32, each
    output rounded to f16, as the TPU backward kernel does at f16."""
    q, k, v, g = _arrays(shape, 4, seed=1)
    ref = pa._sd_attention_bwd_impl(*(jnp.asarray(t, jnp.float16) for t in (q, k, v, g)), True)
    out = tsa.sd_attention_bwd(*(torch.from_numpy(t).half() for t in (q, k, v, g)))
    for name, o, r in zip(("dq", "dk", "dv"), out, ref):
        r = np.asarray(r, np.float32)
        assert o.dtype == torch.float16 and tuple(o.shape) == shape, name
        assert np.abs(o.float().numpy() - r).max() <= _f16_ulps(r, 4), name


@pytest.mark.parametrize("kernel,mode", [
    ("conv3x3", "none"), ("epi", "temb"), ("epi", "residual"), ("fused", "temb"),
    ("fused", "residual"),
])
def test_conv_plain_f16_matches_pallas_conv(kernel, mode):
    """#5-#7: f32 sums, bias and epilogue added in f32, one rounding to f16;
    #6 rounds silu(x a + s) to f16 before the product."""
    B, H, W, C, N = 2, 8, 32, 64, 128
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((B, H, W, C)) * 2 + 0.5).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, N)) * (9 * C) ** -0.5).astype(np.float32)
    b = (rng.standard_normal(N) * 0.1).astype(np.float32)
    a = (1.0 + rng.standard_normal((B, C)) * 0.1).astype(np.float32)
    s = (rng.standard_normal((B, C)) * 0.3).astype(np.float32)
    extra = {"none": None, "temb": rng.standard_normal((B, N)).astype(np.float32),
             "residual": rng.standard_normal((B, H, W, N)).astype(np.float32)}[mode]
    tp = from_jax_params({"conv": {"weight": w, "bias": b}})["conv"]
    jx, jw, jb = (jnp.asarray(t, jnp.float16) for t in (x, w, b))
    je = None if extra is None else jnp.asarray(extra, jnp.float16)
    tx, tw, tbias = torch.from_numpy(x).half(), tp["weight"].half(), tp["bias"].half()
    te = None if extra is None else torch.from_numpy(extra).half()
    if kernel == "conv3x3":
        ref = pc.conv3x3(jx, jw, jb, interpret=True)
        out = tc.conv3x3(tx, tw, tbias)
    elif kernel == "epi":
        ref = pc.epi_conv3x3(jx, jw, jb, je, mode=mode, interpret=True)
        out = tc.epi_conv3x3(tx, tw, tbias, te, mode)
    else:
        ref = pc.fused_conv3x3(jx, jnp.asarray(a), jnp.asarray(s), jw, jb, je, mode=mode,
                               interpret=True)
        out = tc.fused_conv3x3(tx, torch.from_numpy(a), torch.from_numpy(s), tw, tbias, te, mode)
    ref = np.asarray(ref, np.float32)
    assert out.dtype == torch.float16 and tuple(out.shape) == (B, H, W, N)
    assert np.abs(out.float().numpy() - ref).max() <= _f16_ulps(ref, 2)


def test_conv_plan_takes_f16_on_bf16s_plans():
    """f16 runs the Hopper mainloop wherever bf16 does, on the same tiles."""
    for shape, n in (((16, 64, 64, 320), 320), ((16, 32, 32, 1280), 1280),
                     ((16, 16, 16, 1920), 1280), ((2, 16, 16, 128), 128)):
        plan = tc.plan(shape, n, torch.float16)
        assert plan.variant == "hopper" and plan == tc.plan(shape, n, torch.bfloat16)


def test_layout_pin_f16_is_a_bit_exact_copy():
    """#9 in f16: the plain copy keeps every bit (NaN and -0 included) and
    equals the JAX pin, the identity off the TPU."""
    x = torch.randn((2, 40, 24), generator=torch.Generator().manual_seed(3)).half()
    x[0, 0, :3] = torch.tensor([float("nan"), -0.0, 65504.0])
    x = x.transpose(1, 2).contiguous().transpose(1, 2)  # channel-major
    y = tlp.layout_pin_ref(x)
    assert y.is_contiguous() and y.dtype == torch.float16
    assert torch.equal(y.view(torch.int16), x.contiguous().view(torch.int16))
    jbasic.set_layout_pin(True)
    try:
        ref = np.asarray(jbasic.layout_pin(jnp.asarray(x.float().numpy(), jnp.float16)))
    finally:
        jbasic.set_layout_pin(False)
    np.testing.assert_array_equal(y.numpy().view(np.int16), ref.view(np.int16))


def test_f16_wrappers_admit_f16_and_kernels_off_the_f16_path_refuse_it():
    """The wrappers of #1, #2, #5-#7 and #9 take f16 (their checks pass);
    #4 and #8 are on no f16 path and refuse it by name."""
    from sliders_tpu_torch.ops import flash_attention as fa
    from sliders_tpu_torch.ops import group_norm as gn

    q = torch.zeros((1, 2, 1024, 40), dtype=torch.float16)
    tsa._check(q, q, q)
    assert tsa.F16_BWD_DIMS == (40, 64, 80, 128)
    assert tlp._ELEM_BYTES[torch.float16] == 2 and tc._DTYPES[torch.float16] == 2
    q4 = torch.zeros((1, 2, 1024, 128), dtype=torch.float16)
    with pytest.raises(ValueError, match=r"kernel #4\) takes bf16 or f32"):
        fa._check(q4, q4, q4)
    with pytest.raises(ValueError, match="not torch.float16"):
        fa.fwd_plan(torch.float16, 128)
    assert torch.float16 not in fa._DTYPES and torch.float16 not in gn._DTYPES


# ---------------------------------------------------------------------------
# the f16 steps against the JAX f16 steps
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def unet():
    params = junet.init_params(jax.random.key(0), junet.TINY)
    return params, from_jax_params(_np(params))


def _raw_pairs(n_pairs, seed, gs=4.0, L=7, D=32):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_pairs):
        p = {k: rng.standard_normal((L, D)).astype(np.float32)
             for k in ("target", "positive", "neutral", "unconditional")}
        p["guidance_signed"] = np.float32(gs if i % 2 == 0 else -gs / 2)
        out.append(p)
    return out


def _topt(lora):
    return topt.make_optimizer("adamw", topt.make_lr_schedule("constant", LR, 100),
                               trainable_mask=tnet.trainable_mask(lora))


@pytest.fixture
def unet_dtypes(monkeypatch):
    """The dtypes of x and of the prompt embeddings of every UNet call."""
    seen = []
    apply = tunet.apply

    def spy(params, cfg, x, t, ehs, **kw):
        seen.append((x.dtype, ehs.dtype))
        out = apply(params, cfg, x, t, ehs, **kw)
        assert out.dtype == x.dtype
        return out

    monkeypatch.setattr(tunet, "apply", spy)
    return seen


@pytest.fixture
def sum_flags(monkeypatch, unet_dtypes):
    """cuBLAS's fp16 reduced-precision flag at every UNet call."""
    seen = []
    apply = tunet.apply

    def spy(*args, **kw):
        seen.append(torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction)
        return apply(*args, **kw)

    monkeypatch.setattr(tunet, "apply", spy)
    return seen


def _sums_in_f32_during_the_step_only(sum_flags: list) -> None:
    """Every UNet call of the step ran with f16 GEMMs summing in f32 (the JAX
    package's and the CPU's sums); PyTorch's default is back after it."""
    assert sum_flags and set(sum_flags) == {False}
    assert torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction is True
    del sum_flags[:]


def _close_after_adamw(port: dict, ref: dict, steps: int):
    """Every element within 2 lr a step of the JAX LoRA, 97 % within lr / 10."""
    diffs = torch.cat([(port[m][k] - ref[m][k]).abs().flatten()
                       for m in ref for k in ("down", "up")])
    assert diffs.max().item() <= 2 * LR * steps * (1 + 1e-2)
    assert (diffs <= LR / 10).float().mean().item() >= 0.97


def test_text_step_f16_matches_jax(unet, unet_dtypes, sum_flags):
    """Two steps of the port's text step at compute_dtype float16 on f32
    weights against JAX make_text_slider_step(compute_dtype=jnp.float16) on
    the JAX draws: every UNet call in f16 with f16 GEMMs summing in f32
    (`f16_sums_in_f32`), the LoRA's master copy in f32,
    loss and grad norm within 1 %, the LoRA after each update as
    `_close_after_adamw` holds it."""
    params, tparams = unet
    lora = jnet.create_slider_network(jax.random.key(1), params, rank=4, alpha=1.0,
                                      train_method="noxattn")
    sched = jmake_schedule()
    sampler = jmake_sampler(sched, "ddim", MAX_STEPS)
    jtx = jopt.make_optimizer("adamw", jopt.make_lr_schedule("constant", LR, 100),
                              trainable_mask=jnet.trainable_mask(lora))
    jstep = jts.make_text_slider_step(
        junet.TINY, sched, sampler, jtx, max_denoising_steps=MAX_STEPS, resolution=64,
        batch_size=1, compute_dtype=jnp.float16, remat=False, donate=False)
    jstate = jts.SliderTrainState.create(jax.random.key(2), lora, jtx)
    raw = _raw_pairs(2, 3)
    jpairs = jts.stack_prompt_pairs([{k: jnp.asarray(v) for k, v in p.items()} for p in raw])

    tsch = tsched.make_schedule()
    tlora = from_jax_params(_np(lora))
    ttx = _topt(tlora)
    tstep = tts.make_text_slider_step(
        tunet.TINY, tsch, tsched.make_sampler(tsch, "ddim", MAX_STEPS), ttx,
        max_denoising_steps=MAX_STEPS, resolution=64, batch_size=1,
        compute_dtype=torch.float16, remat=False)
    tstate = tts.SliderTrainState.create(0, tlora, ttx)
    tpairs = tts.stack_prompt_pairs(raw)
    for step in range(2):
        key = jax.random.fold_in(jstate.key, jstate.step)
        k_pair, k_t, k_lat, _, _ = jax.random.split(key, 5)
        draws = (int(jax.random.randint(k_pair, (), 0, len(raw))),
                 int(jax.random.randint(k_t, (), 1, MAX_STEPS)),
                 np.asarray(jax.random.normal(k_lat, (1, 8, 8, 4)) * sampler.init_noise_sigma,
                            np.float32))
        jstate, jm = jstep(jstate, params, jpairs)
        del unet_dtypes[:]
        tstate, tm = tstep(tstate, tparams, tpairs, draws=draws)
        assert (tm["pair"], tm["t_to"]) == (int(jm["pair"]), int(jm["t_to"]))
        # the denoise loop's t_to calls, the frozen pass, the grad pass
        assert unet_dtypes == [(torch.float16, torch.float16)] * (tm["t_to"] + 2)
        _sums_in_f32_during_the_step_only(sum_flags)
        assert tm["loss"] == pytest.approx(float(jm["loss"]), rel=1e-2)
        assert tm["grad_norm"] == pytest.approx(float(jm["grad_norm"]), rel=1e-2)
        assert all(t.dtype == torch.float32 for e in tstate.lora.values() for t in e.values())
        _close_after_adamw(tstate.lora, from_jax_params(_np(jstate.lora)), step + 1)


def _jax_fleet_draws(fleet_key, step, n_pairs, shape, sigma):
    """The K rows' draws of the JAX fleet step (per_row), from its keys."""
    rows = []
    for r, n in enumerate(n_pairs):
        key = jax.random.fold_in(jax.random.fold_in(fleet_key, r), step)
        k_pair, k_t, k_lat, _, _ = jax.random.split(key, 5)
        rows.append((int(jax.random.randint(k_pair, (), 0, jnp.int32(n))),
                     int(jax.random.randint(k_t, (), 1, MAX_STEPS)),
                     np.asarray(jax.random.normal(k_lat, shape) * sigma, np.float32)))
    return rows


def test_fleet_step_f16_matches_jax(unet, unet_dtypes, sum_flags):
    """Two steps of the port's text fleet step at K = 2 in f16 on f32
    weights against the JAX fleet step at jnp.float16 on its draws: per-row
    t_to and pair equal, every UNet call in f16 with f16 GEMMs summing in
    f32, per-row loss and grad norm
    within 1 %, the LoRA after each update as `_close_after_adamw` holds it."""
    params, tparams = unet
    counts = (2, 3)
    K = len(counts)
    sched = jmake_schedule()
    sampler = jmake_sampler(sched, "ddim", MAX_STEPS)
    loras = [jnet.create_slider_network(jax.random.key(10 + r), params, rank=4, alpha=1.0,
                                        train_method="noxattn") for r in range(K)]
    stacked = jfleet.stack_fleet(loras)
    jtx = jopt.make_optimizer("adamw", jopt.make_lr_schedule("constant", LR, 100),
                              trainable_mask=jnet.trainable_mask(stacked))
    jstep = jfleet.make_fleet_text_step(
        junet.TINY, sched, sampler, jtx, n_sliders=K, max_denoising_steps=MAX_STEPS,
        resolution=64, batch_size=1, compute_dtype=jnp.float16, remat=False, donate=False)
    fleet_key = jax.random.key(2)
    jstate = jts.SliderTrainState.create(fleet_key, stacked, jtx)
    raw = [_raw_pairs(n, 20 + r, gs=4.0 - 2.0 * r) for r, n in enumerate(counts)]
    jpairs = jfleet.stack_fleet_pairs([jts.stack_prompt_pairs(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in ps]) for ps in raw])

    tsch = tsched.make_schedule()
    tlora = tfleet.stack_fleet([from_jax_params(_np(w)) for w in loras])
    ttx = _topt(tlora)
    tstep = tfleet.make_fleet_text_step(
        tunet.TINY, tsch, tsched.make_sampler(tsch, "ddim", MAX_STEPS), ttx, n_sliders=K,
        max_denoising_steps=MAX_STEPS, resolution=64, batch_size=1,
        compute_dtype=torch.float16, remat=False)
    tstate = tts.SliderTrainState.create(0, tlora, ttx)
    tpairs = tfleet.stack_fleet_pairs([tts.stack_prompt_pairs(ps) for ps in raw])
    for step in range(2):
        draws = _jax_fleet_draws(fleet_key, step, counts, (1, 8, 8, 4),
                                 sampler.init_noise_sigma)
        jstate, jm = jstep(jstate, params, jpairs)
        del unet_dtypes[:]
        tstate, tm = tstep(tstate, tparams, tpairs, draws=draws)
        assert tm["t_to"] == np.asarray(jm["t_to"]).tolist()
        assert tm["pair"] == np.asarray(jm["pair"]).tolist()
        assert unet_dtypes == [(torch.float16, torch.float16)] * (tm["loop"] + 2)
        _sums_in_f32_during_the_step_only(sum_flags)
        np.testing.assert_allclose(tm["loss"], np.asarray(jm["loss"]), rtol=1e-2)
        np.testing.assert_allclose(tm["grad_norm"], np.asarray(jm["grad_norm"]), rtol=1e-2)
        _close_after_adamw(tstate.lora, from_jax_params(_np(jstate.lora)), step + 1)


def test_precision_maps_match_the_jax_package():
    """Load dtype (the JAX CLIs' map) and compute dtype (the JAX loops')."""
    config = types.SimpleNamespace(train=types.SimpleNamespace(precision=""))
    for precision, load, compute in (("bf16", torch.bfloat16, torch.bfloat16),
                                     ("bfloat16", torch.bfloat16, torch.bfloat16),
                                     ("fp16", torch.float32, torch.float16),
                                     ("float16", torch.float32, torch.float16),
                                     ("float32", torch.float32, torch.float32),
                                     ("fp32", torch.float32, torch.float32)):
        config.train.precision = precision
        assert driver.load_dtype_of(config) is load, precision
        assert driver.compute_dtype_of(config) is compute, precision


# ---------------------------------------------------------------------------
# the CLIs under fp16
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    return make_tiny_snapshot(str(tmp_path_factory.mktemp("fp16") / "sd_tiny"))


@pytest.fixture
def load_dtypes(monkeypatch):
    """The dtype every loader call loads its weights in."""
    seen = []
    for name in ("load_sd", "load_flux"):
        real = getattr(loader, name)

        def spy(*a, _real=real, **kw):
            seen.append(kw.get("dtype"))
            return _real(*a, **kw)

        monkeypatch.setattr(loader, name, spy)
    return seen


def _spy_builder(monkeypatch, module, name, seen):
    """Record `compute_dtype` of each call to the step builder `name`."""
    real = getattr(module, name)

    def spy(*a, **kw):
        seen.append(kw["compute_dtype"])
        return real(*a, **kw)

    monkeypatch.setattr(module, name, spy)


def test_flux_cli_runs_f32_under_fp16(tmp_path, monkeypatch, load_dtypes, capsys):
    """train_flux_slider under fp16 loads and computes in f32 (the JAX CLI
    maps every precision but bf16 to f32) and says so."""
    snap = make_tiny_flux_snapshot(str(tmp_path / "flux_tiny"))
    (tmp_path / "prompts.yaml").write_text(
        "- target: person\n  positive: very old person\n  unconditional: ''\n"
        "  neutral: person\n  action: enhance\n  guidance_scale: 1\n"
        "  resolution: 64\n  batch_size: 1\n")
    cfg = tmp_path / "config.yaml"
    cfg.write_text(
        f"prompts_file: {tmp_path / 'prompts.yaml'}\n"
        f"pretrained_model:\n  name_or_path: {snap}\n"
        "network:\n  rank: 2\n  alpha: 1.0\n  training_method: xattn\n"
        "train:\n  precision: fp16\n  iterations: 1\n  lr: 0.0002\n  optimizer: adamw\n"
        "  lr_scheduler: constant\n  max_denoising_steps: 3\n"
        f"save:\n  name: flux_fp16\n  path: {tmp_path / 'out'}\n  per_steps: 10\n"
        "logging:\n  log_every: 1\n"
        "tpu:\n  remat: false\n")
    computes = []
    _spy_builder(monkeypatch, driver, "make_flux_slider_step", computes)
    final = flux_cli.main(flux_cli.build_parser().parse_args(
        ["--config_file", str(cfg), "--t5_len", "16", "--device", "cpu"]))
    assert load_dtypes == [torch.float32] and computes == [torch.float32]
    assert all(torch.isfinite(t).all() for e in final.values() for t in e.values())
    assert ("precision fp16: FLUX slider training runs in float32, as the JAX CLI maps every "
            "precision but bf16 to float32") in capsys.readouterr().out


def test_image_cli_and_image_fleet_run_f32_under_fp16(snapshot, tmp_path, monkeypatch,
                                                      load_dtypes, unet_dtypes, capsys):
    """train_image_slider under fp16, solo and `--stylecheck 1 --fleet`:
    the weights load in f32 and every UNet call runs in f32, as the JAX CLI
    computes; each run says so."""
    (tmp_path / "prompts.yaml").write_text(
        "- target: ''\n  positive: 'big eyes'\n  unconditional: ''\n  neutral: 'eyes'\n"
        "  guidance_scale: 1\n  resolution: 32\n")
    (tmp_path / "config.yaml").write_text(
        f"prompts_file: {tmp_path / 'prompts.yaml'}\n"
        f"pretrained_model:\n  name_or_path: {snapshot}\n"
        "network:\n  rank: 2\n  training_method: noxattn\n"
        "train:\n  precision: fp16\n  iterations: 1\n  lr: 0.001\n  max_denoising_steps: 5\n"
        f"save:\n  name: eyesize\n  path: {tmp_path / 'out'}\n  per_steps: 10\n"
        "logging:\n  log_every: 1\n"
        "tpu:\n  remat: false\n")
    rng = np.random.default_rng(0)
    for style in ("s0", "s1"):
        for folder, val in (("low", 40), ("high", 200)):
            os.makedirs(tmp_path / "styles" / style / folder)
            img = (rng.random((32, 32, 3)) * 20 + val).astype(np.uint8)
            (tmp_path / "styles" / style / folder / "a.png").write_bytes(encode_png(img))
    solo, fleet_runs = [], []
    _spy_builder(monkeypatch, driver, "make_image_slider_step", solo)
    _spy_builder(monkeypatch, tfleet, "make_fleet_image_step", fleet_runs)
    argv = ["--config_file", str(tmp_path / "config.yaml"), "--folders", "low, high",
            "--scales", "-1, 1", "--resolution", "32", "--device", "cpu"]
    image_cli.main(image_cli.build_parser().parse_args(
        argv + ["--folder_main", str(tmp_path / "styles" / "s0")]))
    out = image_cli.main(image_cli.build_parser().parse_args(
        argv + ["--folder_main", str(tmp_path / "styles"), "--stylecheck", "1", "--fleet"]))
    assert len(out) == 2
    assert load_dtypes == [torch.float32] * 2
    assert solo == [torch.float32] and fleet_runs == [torch.float32]
    assert unet_dtypes and set(unet_dtypes) == {(torch.float32, torch.float32)}
    text = capsys.readouterr().out
    assert "precision fp16: image slider training runs in float32" in text
    assert "precision fp16: image fleet training runs in float32" in text
