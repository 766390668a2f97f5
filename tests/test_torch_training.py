"""The port's text-slider training against sliders_tpu on the CPU: the grid
tables, LR schedules and optimizers, the trainable mask, slider files in
both directions, the train step held against the JAX step, and the CLI end
to end on a tiny snapshot.

Tolerances are stated where they are used; the step parity runs the TINY
UNet in f32 at 64 px with lr 1e-4, because Adam turns ULP-level gradient
noise on the zero-initialised `up` factors into lr-sized steps (ROADMAP
queue 3), so atol 1e-5 on the LoRA is meaningful only at a small lr.
"""

import json
import math
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from helpers import make_tiny_snapshot

from sliders_tpu.diffusion import guidance as jguid
from sliders_tpu.diffusion import make_sampler as jmake_sampler
from sliders_tpu.diffusion import make_schedule as jmake_schedule
from sliders_tpu.lora import io as jio
from sliders_tpu.lora import network as jnet
from sliders_tpu.models import unet2d as junet
from sliders_tpu.training import optimizers as jopt
from sliders_tpu.training import text_slider as jts
from sliders_tpu_torch.cli import train_text_slider as tcli
from sliders_tpu_torch.diffusion import guidance as tguid
from sliders_tpu_torch.diffusion import schedulers as tsched
from sliders_tpu_torch.lora import io as tio
from sliders_tpu_torch.lora import network as tnet
from sliders_tpu_torch.models import unet2d as tunet
from sliders_tpu_torch.models import loader
from sliders_tpu_torch.models.convert import from_jax_params, write_safetensors
from sliders_tpu_torch.training import optimizers as topt
from sliders_tpu_torch.training import text_slider as tts

SCHEDULES = ["constant", "cosine", "cosine_with_restarts", "step", "linear"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    """TINY UNet params and a noxattn rank-4 slider, JAX and port copies."""
    params = junet.init_params(jax.random.key(0), junet.TINY)
    lora = jnet.create_slider_network(jax.random.key(1), params, rank=4, alpha=1.0,
                                      train_method="noxattn")
    return params, lora, from_jax_params(_np(params)), from_jax_params(_np(lora))


@pytest.mark.parametrize("kind", ["ddim", "lms"])
def test_train_grid_tables_equal_jax(kind):
    ts, scale = tguid.train_grid_tables(tsched.make_schedule(), kind)
    jts_, jscale = jguid.train_grid_tables(jmake_schedule(), kind)
    assert ts.dtype == scale.dtype == torch.float32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(jts_))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    # the grid jump of the train step is exact at every t_to of a 50-step plan
    for t_to in range(1, 50):
        assert ts[t_to * 1000 // 50].item() == 999 - t_to * 20


@pytest.mark.parametrize("name", SCHEDULES)
def test_lr_schedules_match_jax(name):
    """lr at every update count 0..1200 of a 1000-iteration run, within 1e-6
    of the peak lr (JAX takes the cosines in f32, the port in f64)."""
    ref = jopt.make_lr_schedule(name, 2e-4, 1000)
    out = topt.make_lr_schedule(name, 2e-4, 1000)
    for step in range(0, 1201):
        assert out(step) == pytest.approx(float(ref(step)), rel=0, abs=2e-4 * 1e-6)


def test_unknown_lr_schedule_raises():
    with pytest.raises(ValueError, match="Scheduler must be"):
        topt.make_lr_schedule("bogus", 1e-4, 10)


def _tree_np_to_torch(tree):
    return {m: {k: torch.tensor(np.asarray(v)) for k, v in e.items()} for m, e in tree.items()}


ADAPTIVE = ("prodigy", "dadaptadam", "dadaptadamw", "dadaptlion")


def _adaptive_inner_state(jstate):
    """The optax.contrib state inside the masked chain's first transform."""
    return jstate[0].inner_state


@pytest.mark.parametrize("name,schedule", [
    ("adamw", "constant"), ("adamw", "cosine"), ("adam", "step"), ("lion", "linear"),
    ("prodigy", "constant"), ("prodigy", "cosine"), ("dadaptadam", "linear"),
    ("dadaptadamw", "step"), ("dadaptlion", "cosine_with_restarts")])
def test_optimizer_update_matches_optax(tiny, name, schedule):
    """Three updates (five for the adaptive ones, whose estimates grow from
    the fourth) on the same gradients agree with optax (optax.contrib
    for prodigy and D-Adapt, under the trainable mask) within 1e-7 (f32 sums
    in another order), and the masked alphas stay bit for bit. The adaptive
    ones run at the lr 1.0 their schedules treat as the base, take weight
    decay, and hold their step-size estimate and weighted numerator to
    optax's within 1e-5 relative: their global sums run over the trainable
    leaves only, as optax.masked hands them only those."""
    _, lora, _, _ = tiny
    mask = jnet.trainable_mask(lora)
    adaptive = name in ADAPTIVE
    lr, kw = (1.0, {"weight_decay": 1e-2}) if adaptive else (1e-3, {})
    if name == "prodigy":
        kw["estim_lr0"] = 1e-5
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # dadaptlion's warning: test_optimizer_names
        jtx = jopt.make_optimizer(name, jopt.make_lr_schedule(schedule, lr, 30), dict(kw),
                                  trainable_mask=mask)
        ttx = topt.make_optimizer(name, topt.make_lr_schedule(schedule, lr, 30), dict(kw),
                                  trainable_mask=tnet.trainable_mask(lora))
    jw = lora
    tw = _tree_np_to_torch(_np(lora))
    jstate, tstate = jtx.init(jw), ttx.init(tw)
    rng = np.random.default_rng(0)
    # the adaptive ones on gradients with a common direction, so that their
    # step-size estimates grow
    base = {m: {k: rng.standard_normal(np.shape(v)).astype(np.float32) if adaptive else 0.0
                for k, v in e.items()} for m, e in lora.items()}
    n_updates = 5 if adaptive else 3
    for _ in range(n_updates):
        g = {m: {k: (base[m][k] + rng.standard_normal(np.shape(v)).astype(np.float32)
                     * (0.1 if adaptive else 1.0)).astype(np.float32) for k, v in e.items()}
             for m, e in lora.items()}
        upd, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jw)
        jw = optax.apply_updates(jw, upd)
        ttx.update(tw, _tree_np_to_torch(g), tstate)
    for m in lora:
        for k in ("down", "up"):
            np.testing.assert_allclose(tw[m][k].numpy(), np.asarray(jw[m][k]), rtol=0, atol=1e-7)
        assert tw[m]["alpha"].item() == float(lora[m]["alpha"])
    if adaptive:
        inner = _adaptive_inner_state(jstate)
        assert tstate["count"] == int(inner.count) == n_updates
        for key in ("estim_lr", "numerator_weighted"):
            ref = float(getattr(inner, key))
            assert tstate[key].item() == pytest.approx(ref, rel=1e-5), key
        assert tstate["estim_lr"].item() > kw.get("estim_lr0", 1e-6)  # the estimate grew
        assert set(tstate["exp_avg"][next(iter(lora))]) == {"down", "up"}  # no alpha moments


@pytest.mark.parametrize("name", ["prodigy", "dadaptadamw"])
def test_adaptive_optimizer_resume_equals_uninterrupted(tiny, tmp_path, name):
    """Four updates straight against two, a round trip of the train state
    through the `.pt` file `SliderTrainState.state_dict` writes, and two
    more: the same weights and state, bit for bit."""
    from sliders_tpu_torch.training.text_slider import SliderTrainState

    _, _, _, tlora = tiny
    mk = lambda: topt.make_optimizer(name, topt.make_lr_schedule("cosine", 1.0, 8),  # noqa: E731
                                     trainable_mask=tnet.trainable_mask(tlora))
    rng = np.random.default_rng(4)
    grads = [{m: {k: torch.tensor(rng.standard_normal(tuple(t.shape)), dtype=torch.float32)
                  for k, t in e.items()} for m, e in tlora.items()} for _ in range(4)]

    def fresh():
        tx = mk()
        return tx, SliderTrainState.create(3, {m: {k: t.clone() for k, t in e.items()}
                                               for m, e in tlora.items()}, tx)

    tx, straight = fresh()
    for g in grads:
        tx.update(straight.lora, g, straight.opt_state)
    tx, first = fresh()
    for g in grads[:2]:
        tx.update(first.lora, g, first.opt_state)
    torch.save(first.state_dict(), tmp_path / "s_trainstate.pt")
    resumed = SliderTrainState.from_state_dict(
        torch.load(tmp_path / "s_trainstate.pt", weights_only=True), "cpu")
    tx = mk()
    for g in grads[2:]:
        tx.update(resumed.lora, g, resumed.opt_state)
    assert resumed.opt_state["count"] == straight.opt_state["count"] == 4
    for m in tlora:
        for k in ("down", "up", "alpha"):
            assert torch.equal(resumed.lora[m][k], straight.lora[m][k])
    for key in ("estim_lr", "numerator_weighted"):
        assert torch.equal(resumed.opt_state[key], straight.opt_state[key])


def test_optimizer_names():
    with pytest.warns(UserWarning, match="full-precision adamw"):
        assert topt.make_optimizer("AdamW8bit", lambda s: 1e-4).kind == "adamw"
    assert topt.make_optimizer("Prodigy", lambda s: 1.0).kind == "prodigy"
    for name in ("dadaptadam", "dadaptadamw"):
        assert topt.make_optimizer(name, lambda s: 1.0).kind == "dadapt_adamw"
    with pytest.warns(UserWarning, match="dadaptlion.*dadapt_adamw"):
        assert topt.make_optimizer("dadaptlion", lambda s: 1.0).kind == "dadapt_adamw"
    with pytest.raises(TypeError, match="b1"):
        topt.make_optimizer("prodigy", lambda s: 1.0, {"b1": 0.9})
    with pytest.raises(ValueError, match="Optimizer must be"):
        topt.make_optimizer("sgd", lambda s: 1e-4)
    with pytest.raises(TypeError, match="betas"):
        topt.make_optimizer("adamw", lambda s: 1e-4, {"betas": (0.9, 0.99)})
    assert topt.parse_optimizer_args("weight_decay=0.01 b2=0.99") == \
        jopt.parse_optimizer_args("weight_decay=0.01 b2=0.99")


def test_trainable_mask_freezes_alphas(tiny):
    _, lora, _, tlora = tiny
    assert tnet.trainable_mask(tlora) == jnet.trainable_mask(lora)
    assert tnet.param_count(tlora) == jnet.param_count(lora)
    tx = topt.make_optimizer("adamw", lambda s: 1e-2, trainable_mask=tnet.trainable_mask(tlora))
    w = {m: {k: t.clone() for k, t in e.items()} for m, e in tlora.items()}
    state = tx.init(w)
    grads = {m: {k: torch.ones_like(t) for k, t in e.items()} for m, e in w.items()}
    tx.update(w, grads, state)
    for m in w:
        assert torch.equal(w[m]["alpha"], tlora[m]["alpha"])
        assert not torch.equal(w[m]["down"], tlora[m]["down"])


def test_write_safetensors_is_readable_by_the_package(tmp_path):
    from safetensors import safe_open
    from safetensors.torch import load_file

    state = {"w": torch.randn(3, 5), "b": torch.randn(2, 3).bfloat16(), "i": torch.arange(4),
             "h": torch.randn(4).half(), "empty": torch.zeros(0, 2), "s": torch.tensor(2.0),
             "t": torch.randn(4, 6).t()}
    path = str(tmp_path / "x.safetensors")
    write_safetensors(path, state, {"k": "v"})
    out = load_file(path)
    assert set(out) == set(state)
    for k, v in state.items():
        assert out[k].dtype == v.dtype and torch.equal(out[k], v)
    with safe_open(path, "pt") as f:
        assert f.metadata() == {"k": "v"}


def _trained_like(lora, seed=5):
    """The slider with nonzero up factors, so layouts show."""
    rng = np.random.default_rng(seed)
    return {m: {**e, "up": jnp.asarray(rng.standard_normal(e["up"].shape), jnp.float32)}
            for m, e in lora.items()}


@pytest.mark.parametrize("ext", [".safetensors", ".pt"])
def test_port_saved_slider_loads_in_jax(tiny, tmp_path, ext):
    params, lora, _, _ = tiny
    jw = _trained_like(lora)
    path = str(tmp_path / f"s{ext}")
    tio.save_slider(path, from_jax_params(_np(jw)))
    back = jio.load_slider(path, params)
    assert set(back) == set(jw)
    for m in jw:
        for k in ("down", "up", "alpha"):
            np.testing.assert_array_equal(np.asarray(back[m][k]), np.asarray(jw[m][k]))


@pytest.mark.parametrize("ext", [".safetensors", ".pt"])
def test_jax_saved_slider_loads_in_port(tiny, tmp_path, ext):
    params, lora, tparams, _ = tiny
    jw = _trained_like(lora, seed=6)
    path = str(tmp_path / f"s{ext}")
    jio.save_slider(path, _np(jw))
    back = tio.load_slider(path, tparams)
    ref = from_jax_params(_np(jw))
    assert set(back) == set(ref)
    for m in ref:
        for k in ("down", "up", "alpha"):
            assert torch.equal(back[m][k], ref[m][k])


def test_save_precision_names():
    assert tio.torch_precision("bf16") is torch.bfloat16
    assert tio.torch_precision("float16") is torch.float16
    assert tio.torch_precision("float32") is torch.float32


def _pairs(n_pairs=2, L=7, D=32, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_pairs):
        p = {k: rng.standard_normal((L, D)).astype(np.float32)
             for k in ("target", "positive", "neutral", "unconditional")}
        p["guidance_signed"] = np.float32(4.0 if i == 0 else -2.0)
        out.append(p)
    return out


def _jax_draws(state, n_pairs, max_steps, shape, init_noise_sigma):
    """The draws of the JAX step, recomputed from its key exactly as
    text_slider.py:157-163,177-180 make them."""
    key = jax.random.fold_in(state.key, state.step)
    k_pair, k_t, k_lat, _, _ = jax.random.split(key, 5)
    idx = jax.random.randint(k_pair, (), 0, n_pairs)
    t_to = jax.random.randint(k_t, (), 1, max_steps)
    lat = (jax.random.normal(k_lat, shape) * init_noise_sigma).astype(jnp.float32)
    return int(idx), int(t_to), np.asarray(lat)


def _port_step(tparams, lora, remat, max_steps=5):
    sched = tsched.make_schedule()
    tx = topt.make_optimizer("adamw", topt.make_lr_schedule("constant", 1e-4, 100),
                             trainable_mask=tnet.trainable_mask(lora))
    step = tts.make_text_slider_step(
        tunet.TINY, sched, tsched.make_sampler(sched, "ddim", max_steps), tx,
        max_denoising_steps=max_steps, resolution=64, batch_size=1,
        compute_dtype=torch.float32, remat=remat)
    w = {m: {k: t.clone() for k, t in e.items()} for m, e in lora.items()}
    return step, tts.SliderTrainState.create(0, w, tx)


def test_step_matches_jax(tiny):
    """Two steps of the port's step against JAX make_text_slider_step on the
    same weights and the draws JAX made: loss, grad_norm and the LoRA after
    each update agree within atol 1e-5."""
    params, lora, tparams, tlora = tiny
    max_steps = 5
    sched = jmake_schedule()
    sampler = jmake_sampler(sched, "ddim", max_steps)
    jtx = jopt.make_optimizer("adamw", jopt.make_lr_schedule("constant", 1e-4, 100),
                              trainable_mask=jnet.trainable_mask(lora))
    jstep = jts.make_text_slider_step(
        junet.TINY, sched, sampler, jtx, max_denoising_steps=max_steps, resolution=64,
        batch_size=1, compute_dtype=jnp.float32, remat=False, donate=False)
    jstate = jts.SliderTrainState.create(jax.random.key(2), lora, jtx)
    raw = _pairs()
    jpairs = jts.stack_prompt_pairs([{k: jnp.asarray(v) for k, v in p.items()} for p in raw])
    tpairs = tts.stack_prompt_pairs(raw)

    tstep, tstate = _port_step(tparams, tlora, remat=False, max_steps=max_steps)
    for _ in range(2):
        draws = _jax_draws(jstate, len(raw), max_steps, (1, 8, 8, 4), sampler.init_noise_sigma)
        jstate, jm = jstep(jstate, params, jpairs)
        tstate, tm = tstep(tstate, tparams, tpairs, draws=draws)
        assert (tm["pair"], tm["t_to"]) == (int(jm["pair"]), int(jm["t_to"])) == draws[:2]
        assert tm["phase_ms"] is None  # device times exist only on CUDA
        assert tm["loss"] == pytest.approx(float(jm["loss"]), abs=1e-5)
        assert tm["grad_norm"] == pytest.approx(float(jm["grad_norm"]), abs=1e-5)
        ref = from_jax_params(_np(jstate.lora))
        for m in ref:
            for k in ("down", "up", "alpha"):
                np.testing.assert_allclose(tstate.lora[m][k].numpy(), ref[m][k].numpy(),
                                           rtol=0, atol=1e-5)
    assert tstate.step == int(jstate.step) == 2


def test_step_remat_equals_no_remat(tiny):
    """remat recomputes the transformer blocks in the backward; the loss and
    the updated LoRA are the same (f32, same draws)."""
    _, _, tparams, tlora = tiny
    raw = _pairs(n_pairs=1)
    pairs = tts.stack_prompt_pairs(raw)
    draws = tts.step_draws(0, 0, 1, 5, (1, 8, 8, 4), 1.0)
    (s_off, st_off), (s_on, st_on) = _port_step(tparams, tlora, False), \
        _port_step(tparams, tlora, True)
    st_off, m_off = s_off(st_off, tparams, pairs, draws=draws)
    st_on, m_on = s_on(st_on, tparams, pairs, draws=draws)
    assert m_on["loss"] == pytest.approx(m_off["loss"], rel=1e-6, abs=1e-9)
    assert m_on["grad_norm"] == pytest.approx(m_off["grad_norm"], rel=1e-6)
    for m in st_on.lora:
        for k in ("down", "up"):
            np.testing.assert_allclose(st_on.lora[m][k].numpy(), st_off.lora[m][k].numpy(),
                                       rtol=0, atol=1e-7)


def test_step_draws_repeat_per_step():
    a = tts.step_draws(7, 3, 4, 50, (1, 8, 8, 4), 1.0)
    b = tts.step_draws(7, 3, 4, 50, (1, 8, 8, 4), 1.0)
    c = tts.step_draws(7, 4, 4, 50, (1, 8, 8, 4), 1.0)
    assert a[:2] == b[:2] and torch.equal(a[2], b[2]) and not torch.equal(a[2], c[2])
    assert 0 <= a[0] < 4 and 1 <= a[1] < 50


@pytest.mark.parametrize("kw,item", [({"fused_tail": True}, "item 18"),
                                     ({"denoise_merged": True}, "item 18"),
                                     ({"chunk": 2}, "item 18"), ({"mesh": object()}, "item 15")])
def test_step_variants_not_ported_raise(kw, item):
    sched = tsched.make_schedule()
    with pytest.raises(NotImplementedError, match=item):
        tts.make_text_slider_step(tunet.TINY, sched, tsched.make_sampler(sched, "ddim", 5),
                                  None, **kw)


# ---------------------------------------------------------------------------
# the CLI end to end on the CPU
# ---------------------------------------------------------------------------

RUN_NAME = "tiny_slider_alpha1.0_rank2_noxattn"


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The run config of tests/test_integration.py::run_cfg (64 px, 6
    iterations, per_steps 3) as YAML, plus state_checkpoint_every 3."""
    root = tmp_path_factory.mktemp("cli")
    snapshot = make_tiny_snapshot(str(root / "sd_tiny"))
    (root / "prompts.yaml").write_text(
        "- target: person\n  positive: old person\n  unconditional: ''\n"
        "  neutral: person\n  action: enhance\n  guidance_scale: 2\n"
        "  resolution: 64\n  batch_size: 1\n")
    config = root / "config.yaml"
    config.write_text(
        f"prompts_file: {root / 'prompts.yaml'}\n"
        f"pretrained_model:\n  name_or_path: {snapshot}\n"
        "network:\n  rank: 2\n  alpha: 1.0\n  training_method: noxattn\n"
        "train:\n  precision: float32\n  noise_scheduler: ddim\n  iterations: 6\n  lr: 0.001\n"
        "  optimizer: adamw\n  lr_scheduler: constant\n  max_denoising_steps: 5\n"
        f"save:\n  name: tiny_slider\n  path: {root / 'out'}\n  per_steps: 3\n"
        "logging:\n  verbose: false\n  log_every: 2\n"
        "tpu:\n  remat: false\n  donate: false\n  state_checkpoint_every: 3\n")
    return root, str(config), snapshot


def _run_cli(argv):
    seen = []
    final = tcli.main(tcli.build_parser().parse_args(argv),
                      on_step=lambda i, state, m: seen.append((i, m)))
    return final, seen


def test_cli_trains_saves_and_resumes(cli_run, capsys):
    root, config, snapshot = cli_run
    final, seen = _run_cli(["--config_file", config, "--device", "cpu"])
    out_dir = root / "out" / RUN_NAME
    # the JAX CLI's artifact names, with the port's .pt train state
    assert sorted(os.listdir(out_dir)) == sorted(
        f"{RUN_NAME}{suffix}" for suffix in
        ("_3steps.safetensors", "_last.safetensors", "_metadata.json", "_trainstate.pt"))
    assert [i for i, _ in seen] == list(range(6))
    assert all(math.isfinite(m["loss"]) and 1 <= m["t_to"] < 5 for _, m in seen)
    log = capsys.readouterr().out
    assert "create LoRA for U-Net: 16 modules." in log and "step 0: loss*1k=" in log
    meta = json.loads((out_dir / f"{RUN_NAME}_metadata.json").read_text())
    assert meta["config"]["network"]["rank"] == 2 and meta["prompts"][0]["target"] == "person"

    tparams = loader.load_sd(snapshot, dtype=torch.float32).unet_params
    last = tio.load_slider(str(out_dir / f"{RUN_NAME}_last.safetensors"), tparams)
    assert set(last) == set(final)
    for m in final:
        for k in ("down", "up", "alpha"):
            assert torch.equal(last[m][k], final[m][k])
    assert any(final[m]["up"].abs().max() > 0 for m in final)  # the slider moved

    state_path = out_dir / f"{RUN_NAME}_trainstate.pt"
    state = torch.load(state_path, weights_only=True)
    assert state["step"] == 4  # checkpointed after step 3
    _, resumed = _run_cli(["--config_file", config, "--device", "cpu",
                           "--resume", str(state_path)])
    assert "at step 4" in capsys.readouterr().out
    assert [i for i, _ in resumed] == [4, 5]
    # the draws follow (seed, step), so the resumed steps repeat the first run's
    assert [(m["pair"], m["t_to"]) for _, m in resumed] == \
        [(m["pair"], m["t_to"]) for i, m in seen if i >= 4]


def test_cli_refuses_cuda_without_a_card(cli_run):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, config, _ = cli_run
    with pytest.raises(RuntimeError, match="no.*CUDA|none is available"):
        _run_cli(["--config_file", config, "--device", "0"])


def test_cli_refuses_jax_states(cli_run, tmp_path):
    _, config, _ = cli_run
    msgpack = tmp_path / "x_trainstate.msgpack"
    msgpack.write_bytes(b"\x80")
    with pytest.raises(ValueError, match="do not resume in the port"):
        _run_cli(["--config_file", config, "--device", "cpu", "--resume", str(msgpack)])


@pytest.mark.parametrize(
    "old,new,item",
    [("tpu:\n", "tpu:\n  dp: 2\n", "item 15"), ("tpu:\n", "tpu:\n  tp: 2\n", "item 15"),
     ("tpu:\n", "tpu:\n  profile_dir: /x\n", "item 16"),
     ("logging:\n", "logging:\n  use_wandb: true\n", "item 16"),
     ("precision: float32", "precision: fp16", "item 2")],
)
def test_driver_refuses_unported_options(cli_run, tmp_path, old, new, item):
    _, config, _ = cli_run
    body = open(config).read().replace(old, new, 1)
    path = tmp_path / "c.yaml"
    path.write_text(body)
    with pytest.raises(NotImplementedError, match=item):
        _run_cli(["--config_file", str(path), "--device", "cpu"])
