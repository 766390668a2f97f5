"""The port's text-slider fleet (`sliders_tpu_torch/training/fleet.py`) on
the CPU: the tree and pair helpers, the t_to modes' draws, the step
builders' refusals, the fleet step against the JAX package's fleet step on
its draws (DDIM at K = 2 with pair counts 2 and 3, LMS at K = 4 and B = 1, where a
freeze mask that tells the LMS history from the latents by shape would
land on the history axis, and Euler-ancestral), and the port's own
contracts: row r is the solo run of seed `fleet_row_seed(seed, r)`, rows
are isolated bit for bit, the steps run under cuDNN's deterministic
algorithms, and an SDXL fleet with a dynamic-crop pair equals
its solo XL runs.

The steps run the TINY UNet in f32 at 64 px with lr 1e-4 (a small lr: Adam
turns ULP-level gradient noise on the zero-initialised `up` factors into
lr-sized steps, so atol 1e-5 on the LoRA means something only there), as
`tests/test_torch_training.py::test_step_matches_jax` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_tpu.diffusion import make_sampler as jmake_sampler
from sliders_tpu.diffusion import make_schedule as jmake_schedule
from sliders_tpu.lora import network as jnet
from sliders_tpu.models import unet2d as junet
from sliders_tpu.training import fleet as jfleet
from sliders_tpu.training import optimizers as jopt
from sliders_tpu.training import text_slider as jts
from sliders_tpu_torch.diffusion import schedulers as tsched
from sliders_tpu_torch.lora import network as tnet
from sliders_tpu_torch.models import unet2d as tunet
from sliders_tpu_torch.models.convert import from_jax_params
from sliders_tpu_torch.training import fleet as tfleet
from sliders_tpu_torch.training import optimizers as topt
from sliders_tpu_torch.training import text_slider as tts

MAX_STEPS = 5
LR = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny tensors gain nothing from torch's thread pool, and beside the
    other test workers its threads oversubscribe the CPU; results are held
    to tolerances or compared within one thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


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


def _tlora(params_t, seed, rank=4):
    return tnet.create_slider_network(torch.Generator().manual_seed(seed), params_t, rank=rank,
                                      alpha=1.0, train_method="noxattn")


def _topt(lora):
    return topt.make_optimizer("adamw", topt.make_lr_schedule("constant", LR, 100),
                               trainable_mask=tnet.trainable_mask(lora))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def test_stack_unstack_roundtrip(unet):
    _, tparams = unet
    loras = [_tlora(tparams, s) for s in (1, 2, 3)]
    fleet = tfleet.stack_fleet(loras)
    assert tfleet.fleet_size(fleet) == 3
    # no `rank` leaf: ops/basic reads the rank from the factors
    assert set(next(iter(fleet.values()))) == {"down", "up", "alpha"}
    for a, b in zip(loras, tfleet.unstack_fleet(fleet)):
        assert set(a) == set(b)
        for m in a:
            for k in ("down", "up", "alpha"):
                assert torch.equal(a[m][k], b[m][k])


def test_stack_fleet_rejects_mixed_ranks(unet):
    _, tparams = unet
    with pytest.raises(ValueError, match="one rank"):
        tfleet.stack_fleet([_tlora(tparams, 1, rank=2), _tlora(tparams, 2, rank=4)])


def test_stack_fleet_pairs_pads_and_bounds():
    p1 = tts.stack_prompt_pairs(_raw_pairs(1, 0))
    p2 = tts.stack_prompt_pairs(_raw_pairs(3, 1))
    stacked = tfleet.stack_fleet_pairs([p1, p2])
    assert stacked["target"].shape[:2] == (2, 3)
    assert stacked["n_pairs"].tolist() == [1, 3] and stacked["n_pairs"].dtype == torch.int32
    # padded rows repeat the last real pair and are never drawn
    assert torch.equal(stacked["target"][0, 2], stacked["target"][0, 0])
    for step in range(40):
        draws = tfleet.fleet_step_draws(5, step, [1, 3], MAX_STEPS, (1, 8, 8, 4), 1.0)
        assert draws[0][0] == 0 and 0 <= draws[1][0] < 3
    with pytest.raises(ValueError, match="different keys"):
        tfleet.stack_fleet_pairs([p1, {**p2, "extra": p2["target"]}])


def test_fleet_row_seed_streams():
    seeds = [tfleet.fleet_row_seed(s, r) for s in (0, 1, 7) for r in range(8)]
    assert len(set(seeds)) == len(seeds) and all(0 <= x < 2**31 for x in seeds)
    assert tfleet.fleet_row_seed(3, 2) == tfleet.fleet_row_seed(3, 2)
    # per_row: row r draws exactly the solo stream of its seed
    rows = tfleet.fleet_step_draws(3, 4, [2, 5], 50, (1, 8, 8, 4), 1.0, ancestral=True)
    for r, n in enumerate((2, 5)):
        solo = tts.step_draws(tfleet.fleet_row_seed(3, r), 4, n, 50, (1, 8, 8, 4), 1.0,
                              ancestral=True)
        assert rows[r][:2] == solo[:2] and torch.equal(rows[r][2], solo[2])
        assert torch.equal(rows[r][4], solo[4])


def test_draw_fleet_t_to_modes():
    """Each mode keeps every row's marginal Uniform{1..T-1} (chi-square over
    6000 steps, 48 degrees of freedom, p = 0.999 at 84.0: gated at 90);
    shared gives every row row 0's draw; stratified rows lie within
    ceil((T-1)/S) + 1 of each other and its E[max of K] sits near the
    analytic (T-1)/S ((S-1)/2 + K/(K+1)) + 1, well below per_row's."""
    K, T, S, N = 4, 50, 8, 6000
    modes = {m: np.array([[d[1] for d in tfleet.fleet_step_draws(
        11, step, [1] * K, T, (1, 1, 1, 1), 1.0, mode=m, strata=S)] for step in range(N)])
        for m in tfleet.T_TO_MODES}
    R = T - 1
    for m, t in modes.items():
        assert t.min() >= 1 and t.max() <= R, m
        for r in range(K):
            counts = np.bincount(t[:, r], minlength=T)[1:T]
            chi2 = float(((counts - N / R) ** 2 / (N / R)).sum())
            assert chi2 < 90, (m, r, chi2)
    assert (modes["shared"] == modes["per_row"][:, :1]).all()
    strat = modes["stratified"]
    assert (strat.max(1) - strat.min(1)).max() <= int(np.ceil(R / S)) + 1
    analytic = R / S * ((S - 1) / 2 + K / (K + 1)) + 1
    assert abs(strat.max(1).mean() - analytic) < 1.0
    assert strat.max(1).mean() < 0.75 * modes["per_row"].max(1).mean()
    # the pure rule: the clamp at the top of the range
    assert tfleet.draw_fleet_t_to([5, 7], T, mode="stratified", stratum=S - 1,
                                  u=[0.99999994, 0.0], strata=S) == [R, 43]


def _builder(mode=None, **kw):
    sched = tsched.make_schedule()
    return tfleet.make_fleet_text_step(tunet.TINY, sched, tsched.make_sampler(sched, "ddim", 10),
                                       topt.make_optimizer("adamw", lambda s: 1e-4),
                                       n_sliders=2, max_denoising_steps=10, t_to_mode=mode, **kw)


def test_t_to_mode_validation_and_variants():
    with pytest.raises(ValueError, match="conflicts"):
        _builder("stratified", shared_t_to=True)
    with pytest.raises(ValueError, match="t_to_mode"):
        _builder("bogus")
    with pytest.raises(ValueError, match="t_to_strata"):
        _builder("stratified", t_to_strata=0)
    with pytest.raises(NotImplementedError, match="item 18"):
        _builder(chunk=2)
    # the dp-sharded fleet is ported: a mesh builds, and K % dp raises JAX's error
    from sliders_tpu_torch.parallel.mesh import make_mesh

    assert callable(_builder(mesh=make_mesh(dp=2, world=2)))
    with pytest.raises(ValueError, match=r"fleet size 2 must divide over dp=4"):
        _builder(mesh=make_mesh(dp=4, world=4))


@pytest.mark.parametrize("name", ["prodigy", "dadaptadam", "dadaptadamw", "dadaptlion"])
def test_fleet_refuses_global_optimizers(name):
    """By name, as the JAX fleet refuses them, in both fleet steps."""
    sched = tsched.make_schedule()
    sampler = tsched.make_sampler(sched, "ddim", 10)
    with pytest.raises(NotImplementedError, match="couple fleet rows"):
        tfleet.make_fleet_text_step(tunet.TINY, sched, sampler, None, n_sliders=2,
                                    optimizer_name=name)
    with pytest.raises(NotImplementedError, match="couple fleet rows"):
        tfleet.make_fleet_image_step(tunet.TINY, None, sched, sampler, None, n_sliders=2,
                                     optimizer_name=name)
    with pytest.warns(UserWarning) if name == "dadaptlion" else _nothing():
        tx = topt.make_optimizer(name, lambda s: 1.0)
    with pytest.raises(NotImplementedError, match="couple fleet rows"):
        tfleet.make_fleet_text_step(tunet.TINY, sched, sampler, tx, n_sliders=2)


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# ---------------------------------------------------------------------------
# the fleet step against the JAX fleet step, on the JAX package's draws
# ---------------------------------------------------------------------------


def _jax_fleet_draws(fleet_key, step, n_pairs, shape, sigma, ancestral):
    """The K rows' draws of the JAX fleet step (per_row), recomputed from its
    keys as fleet.py:375-447 makes them."""
    rows = []
    for r, n in enumerate(n_pairs):
        key = jax.random.fold_in(jax.random.fold_in(fleet_key, r), step)
        k_pair, k_t, k_lat, k_anc, _ = jax.random.split(key, 5)
        idx = int(jax.random.randint(k_pair, (), 0, jnp.int32(n)))
        t_to = int(jax.random.randint(k_t, (), 1, MAX_STEPS))
        lat = np.asarray(jax.random.normal(k_lat, shape) * sigma, np.float32)
        draw = [idx, t_to, lat]
        if ancestral:
            draw += [None, np.stack([np.asarray(jax.random.normal(
                jax.random.fold_in(k_anc, i), shape, jnp.float32)) for i in range(t_to)])]
        rows.append(tuple(draw))
    return rows


CASES = {  # kind, pair counts per slider (K = len), batch
    "ddim_k2": ("ddim", (2, 3), 1),
    "lms_k4": ("lms", (2, 2, 2, 2), 1),
    "euler_a_k2": ("euler_a", (2, 2), 1),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def jax_case(request, unet):
    """One JAX fleet step per case, built once for the module."""
    kind, counts, B = CASES[request.param]
    params, _ = unet
    K = len(counts)
    sched = jmake_schedule()
    sampler = jmake_sampler(sched, kind, MAX_STEPS)
    loras = [jnet.create_slider_network(jax.random.key(10 + r), params, rank=4, alpha=1.0,
                                        train_method="noxattn") for r in range(K)]
    fleet = jfleet.stack_fleet(loras)
    jtx = jopt.make_optimizer("adamw", jopt.make_lr_schedule("constant", LR, 100),
                              trainable_mask=jnet.trainable_mask(fleet))
    step = jfleet.make_fleet_text_step(
        junet.TINY, sched, sampler, jtx, n_sliders=K, max_denoising_steps=MAX_STEPS,
        resolution=64, batch_size=B, compute_dtype=jnp.float32, remat=False, donate=False)
    raw = [_raw_pairs(n, 20 + r, gs=4.0 - 2.0 * r) for r, n in enumerate(counts)]
    return request.param, kind, counts, B, loras, fleet, jtx, step, raw, sampler


def test_fleet_step_matches_jax(unet, jax_case):
    """Two steps of the port's fleet step against the JAX fleet step on the
    same weights and the JAX draws: per-row t_to and pair equal, per-row
    loss and grad norm within 1e-5, the LoRA after each update within atol
    1e-5. The LMS case runs K * B == LMS_ORDER == 4."""
    params, tparams = unet
    name, kind, counts, B, loras, fleet, jtx, jstep, raw, jsampler = jax_case
    K = len(counts)
    fleet_key = jax.random.key(2)
    jstate = jts.SliderTrainState.create(fleet_key, fleet, jtx)
    jpairs = jfleet.stack_fleet_pairs([jts.stack_prompt_pairs(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in ps]) for ps in raw])

    sched = tsched.make_schedule()
    tlora = tfleet.stack_fleet([from_jax_params(_np(w)) for w in loras])
    ttx = _topt(tlora)
    tstep = tfleet.make_fleet_text_step(
        tunet.TINY, sched, tsched.make_sampler(sched, kind, MAX_STEPS), ttx, n_sliders=K,
        max_denoising_steps=MAX_STEPS, resolution=64, batch_size=B,
        compute_dtype=torch.float32, remat=False)
    tstate = tts.SliderTrainState.create(0, tlora, ttx)
    tpairs = tfleet.stack_fleet_pairs([tts.stack_prompt_pairs(ps) for ps in raw])
    loops = []
    for step in range(2):
        draws = _jax_fleet_draws(fleet_key, step, counts, (B, 8, 8, 4),
                                 jsampler.init_noise_sigma, kind == "euler_a")
        jstate, jm = jstep(jstate, params, jpairs)
        tstate, tm = tstep(tstate, tparams, tpairs, draws=draws)
        assert tm["t_to"] == np.asarray(jm["t_to"]).tolist() == [d[1] for d in draws]
        assert tm["pair"] == np.asarray(jm["pair"]).tolist()
        assert tm["loop"] == max(tm["t_to"]) and tm["phase_ms"] is None
        np.testing.assert_allclose(tm["loss"], np.asarray(jm["loss"]), rtol=0, atol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"], np.asarray(jm["grad_norm"]), rtol=0,
                                   atol=1e-5)
        ref = from_jax_params(_np(jstate.lora))
        for m in ref:
            for k in ("down", "up", "alpha"):
                np.testing.assert_allclose(tstate.lora[m][k].numpy(), ref[m][k].numpy(),
                                           rtol=0, atol=1e-5, err_msg=f"{name} {m}.{k}")
        loops.append(tm["loop"])
    assert tstate.step == 2


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------


def _port_fleet(tparams, raw_sets, seed=9, steps=2, kind="ddim", mode=None, xl=False,
                cfg=tunet.TINY, seeds=None):
    """`steps` fleet steps from the initial LoRAs of the rows' solo seeds;
    returns (state, metrics list)."""
    K = len(raw_sets)
    sched = tsched.make_schedule()
    seeds = seeds or [tfleet.fleet_row_seed(seed, r) for r in range(K)]
    tlora = tfleet.stack_fleet([_tlora(tparams, s + 1) for s in seeds])
    tx = _topt(tlora)
    step = tfleet.make_fleet_text_step(
        cfg, sched, tsched.make_sampler(sched, kind, MAX_STEPS), tx, n_sliders=K,
        max_denoising_steps=MAX_STEPS, resolution=64, batch_size=1,
        compute_dtype=torch.float32, remat=False, is_xl=xl, t_to_mode=mode, t_to_strata=2)
    state = tts.SliderTrainState.create(seed, tlora, tx)
    pairs = tfleet.stack_fleet_pairs([tts.stack_prompt_pairs(ps) for ps in raw_sets])
    ms = []
    for _ in range(steps):
        state, m = step(state, tparams, pairs)
        ms.append(m)
    return state, ms


def _port_solo(tparams, raw, seed, steps=2, kind="ddim", xl=False, cfg=tunet.TINY):
    sched = tsched.make_schedule()
    lora = _tlora(tparams, seed + 1)
    tx = _topt(lora)
    step = tts.make_text_slider_step(
        cfg, sched, tsched.make_sampler(sched, kind, MAX_STEPS), tx,
        max_denoising_steps=MAX_STEPS, resolution=64, batch_size=1,
        compute_dtype=torch.float32, remat=False, is_xl=xl)
    state = tts.SliderTrainState.create(seed, lora, tx)
    pairs = tts.stack_prompt_pairs(raw)
    ms = []
    for _ in range(steps):
        state, m = step(state, tparams, pairs)
        ms.append(m)
    return state, ms


@pytest.mark.parametrize("kind", ["ddim", "ddpm"])
def test_rows_are_solo_runs_of_their_seeds(unet, kind):
    """Row r of a fleet run with seed s is the port's solo run with seed
    `fleet_row_seed(s, r)`: the same draws (t_to, pair), losses within 1e-5
    relative and the LoRA within atol 1e-5 after two steps."""
    _, tparams = unet
    raw = [_raw_pairs(2, 30), _raw_pairs(3, 31, gs=-2.0)]
    state, ms = _port_fleet(tparams, raw, kind=kind)
    rows = tfleet.unstack_fleet(state.lora)
    for r in range(2):
        solo, sms = _port_solo(tparams, raw[r], tfleet.fleet_row_seed(9, r), kind=kind)
        for m, sm in zip(ms, sms):
            assert (m["t_to"][r], m["pair"][r]) == (sm["t_to"], sm["pair"])
            assert m["loss"][r] == pytest.approx(sm["loss"], rel=1e-5)
            assert m["grad_norm"][r] == pytest.approx(sm["grad_norm"], rel=1e-5)
        for mod in solo.lora:
            for k in ("down", "up", "alpha"):
                np.testing.assert_allclose(rows[r][mod][k].numpy(), solo.lora[mod][k].numpy(),
                                           rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["per_row", "stratified"])
def test_rows_are_isolated_bit_for_bit(unet, mode):
    """Changing row 1's prompt pairs moves row 0's LoRA, loss and draws by
    not one bit."""
    _, tparams = unet
    a = [_raw_pairs(2, 40), _raw_pairs(2, 41)]
    b = [a[0], _raw_pairs(3, 42, gs=-6.0)]
    sa, ma = _port_fleet(tparams, a, mode=mode)
    sb, mb = _port_fleet(tparams, b, mode=mode)
    assert [m["t_to"][0] for m in ma] == [m["t_to"][0] for m in mb]
    assert [m["loss"][0] for m in ma] == [m["loss"][0] for m in mb]
    ra, rb = tfleet.unstack_fleet(sa.lora)[0], tfleet.unstack_fleet(sb.lora)[0]
    for m in ra:
        for k in ("down", "up"):
            assert torch.equal(ra[m][k], rb[m][k])
    assert any(not torch.equal(x["up"], y["up"]) for x, y in zip(
        tfleet.unstack_fleet(sa.lora)[1].values(), tfleet.unstack_fleet(sb.lora)[1].values()))


def test_fleet_steps_run_under_deterministic_cudnn(unet, monkeypatch):
    """Every UNet call of a fleet step, forward and backward, runs with
    cuDNN's deterministic algorithms and without its benchmark search (the
    rows' bit isolation on the card); the flags are restored after the step,
    and after a step that raises."""
    _, tparams = unet
    cudnn = torch.backends.cudnn
    seen, apply = [], tunet.apply

    def spy(*args, **kwargs):
        seen.append((cudnn.deterministic, cudnn.benchmark))
        return apply(*args, **kwargs)

    monkeypatch.setattr(tunet, "apply", spy)
    before = (cudnn.deterministic, cudnn.benchmark)
    _port_fleet(tparams, [_raw_pairs(2, 60), _raw_pairs(2, 61)], steps=1)
    assert seen and set(seen) == {(True, False)}
    assert (cudnn.deterministic, cudnn.benchmark) == before
    with pytest.raises(ValueError, match="rows of draws"):
        step = tfleet.make_fleet_text_step(
            tunet.TINY, tsched.make_schedule(),
            tsched.make_sampler(tsched.make_schedule(), "ddim", MAX_STEPS), None, n_sliders=2,
            max_denoising_steps=MAX_STEPS, resolution=64)
        step(None, tparams, tfleet.stack_fleet_pairs(
            [tts.stack_prompt_pairs(_raw_pairs(2, 62))] * 2), draws=[])
    assert (cudnn.deterministic, cudnn.benchmark) == before


def test_shared_mode_gives_row_zero_draw(unet):
    """shared: every row denoises to row 0's t_to, and row 0 is still its
    solo run."""
    _, tparams = unet
    raw = [_raw_pairs(2, 50), _raw_pairs(2, 51)]
    state, ms = _port_fleet(tparams, raw, mode="shared", steps=1)
    solo, sms = _port_solo(tparams, raw[0], tfleet.fleet_row_seed(9, 0), steps=1)
    assert ms[0]["t_to"] == [sms[0]["t_to"]] * 2 and ms[0]["loop"] == sms[0]["t_to"]
    assert ms[0]["loss"][0] == pytest.approx(sms[0]["loss"], rel=1e-5)


def test_sdxl_fleet_with_dynamic_crop_matches_solo_xl_steps():
    """A tiny SDXL fleet (K = 2), row 0 a dynamic-crop pair, row 1 a static
    one: each row's per-row pooled embeddings, time ids and crop equal its
    solo XL run's (losses within 1e-5 relative, LoRA within atol 1e-5)."""
    jparams = junet.init_params(jax.random.key(0), junet.TINY_XL)
    tparams = from_jax_params(_np(jparams))
    rng = np.random.default_rng(60)
    raw = []
    for r in range(2):
        ps = []
        for i in range(2):
            p = {k: rng.standard_normal((7, 32)).astype(np.float32)
                 for k in ("target", "positive", "neutral", "unconditional")}
            p.update({f"pooled_{k}": rng.standard_normal(16).astype(np.float32)
                      for k in ("target", "positive", "neutral", "unconditional")})
            p["guidance_signed"] = np.float32(3.0)
            from sliders_tpu_torch.pipelines.text2image import get_add_time_ids
            p["time_ids"] = get_add_time_ids(64, 64)[0].numpy()
            p["dynamic_crops"] = np.float32(1.0 if r == 0 else 0.0)
            ps.append(p)
        raw.append(ps)
    state, ms = _port_fleet(tparams, raw, xl=True, cfg=tunet.TINY_XL)
    rows = tfleet.unstack_fleet(state.lora)
    for r in range(2):
        solo, sms = _port_solo(tparams, raw[r], tfleet.fleet_row_seed(9, r), xl=True,
                               cfg=tunet.TINY_XL)
        for m, sm in zip(ms, sms):
            assert (m["t_to"][r], m["pair"][r]) == (sm["t_to"], sm["pair"])
            assert m["loss"][r] == pytest.approx(sm["loss"], rel=1e-5)
        for mod in solo.lora:
            for k in ("down", "up"):
                np.testing.assert_allclose(rows[r][mod][k].numpy(), solo.lora[mod][k].numpy(),
                                           rtol=0, atol=1e-5)
