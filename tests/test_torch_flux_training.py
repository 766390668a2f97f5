"""The port's FLUX slider training against sliders_tpu on the CPU: the
ortho-up LoRA and its mask, the optimizer on a frozen leaf, the merged-weight
LoRA and its gradient, the transformer's block remat, the train step held
against the JAX step on the JAX package's draws, twenty steps, and the CLI
end to end on the tiny FLUX snapshot.

Everything runs the TINY FLUX config at 64 px (16 image tokens). The step
parity runs f32 at lr 1e-4 (the Adam trap of ROADMAP queue 3: Adam turns
ULP-level gradient noise into lr-sized steps, so atol 1e-5 on `down` means
something only at a small lr). Tolerances are stated where they are used.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers import make_tiny_flux_snapshot

from sliders_tpu.diffusion import schedulers as js
from sliders_tpu.lora import merge as jmerge
from sliders_tpu.lora import network as jnet
from sliders_tpu.models import flux as jflux
from sliders_tpu.training import flux_slider as jfs
from sliders_tpu.training import optimizers as jopt
from sliders_tpu.training import text_slider as jts
from sliders_tpu_torch.cli import train_flux_slider as tcli
from sliders_tpu_torch.diffusion import schedulers as ts
from sliders_tpu_torch.lora import merge as tmerge
from sliders_tpu_torch.lora import network as tnet
from sliders_tpu_torch.models import flux
from sliders_tpu_torch.models.convert import from_jax_params, read_safetensors
from sliders_tpu_torch.training import flux_slider as tfs
from sliders_tpu_torch.training import optimizers as topt
from sliders_tpu_torch.training import text_slider as tts
from sliders_tpu_torch.utils import pytree

N_STEPS = 4  # FlowMatch steps of the step tests (t_to in [1, 4))
LR = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    """TINY FLUX params and an xattn rank-4 ortho-up slider, JAX and port."""
    params = jflux.init_params(jax.random.key(0), jflux.TINY)
    lora = jnet.create_slider_network(jax.random.key(1), params, rank=4, alpha=1.0,
                                      train_method="xattn", ortho_up=True)
    return params, lora, from_jax_params(_np(params)), from_jax_params(_np(lora))


def _with_up(lora, seed):
    """The slider with random up factors, so the merge's delta is nonzero."""
    rng = np.random.default_rng(seed)
    return {m: {**e, "up": jnp.asarray(rng.standard_normal(e["up"].shape) * 0.1, jnp.float32)}
            for m, e in lora.items()}


# -- ortho_up -------------------------------------------------------------------


def test_ortho_up_init_and_mask(tiny):
    """up (out, r) is orthonormal (up^T up = I within 1e-4: f32 QR), its
    columns distinct; down keeps kaiming-uniform (every value within the
    bound, the spread of a uniform within 10 %); trainable_mask freezes up
    and the alphas as the JAX mask does; the targets equal the JAX tree's."""
    params, jlora, tparams, _ = tiny
    lora = tnet.create_slider_network(torch.Generator().manual_seed(3), tparams, rank=4,
                                      alpha=1.0, train_method="xattn", ortho_up=True)
    assert set(lora) == set(jlora)
    downs = []
    for m, e in lora.items():
        up, down = e["up"], e["down"]
        assert up.shape == jlora[m]["up"].shape[::-1] and down.shape == jlora[m]["down"].shape[::-1]
        torch.testing.assert_close(up.T @ up, torch.eye(4), rtol=0, atol=1e-4)
        assert len({tuple(c) for c in up.T.round(decimals=5).tolist()}) == 4
        bound = math.sqrt(6.0 / (2.0 * down.shape[1]))  # kaiming-uniform, a = 1
        assert down.abs().max().item() <= bound
        downs.append(down.flatten() / bound)
    spread = torch.cat(downs).std().item()
    assert abs(spread - 1 / math.sqrt(3)) <= 0.1 / math.sqrt(3)
    mask = tnet.trainable_mask(lora, ortho_up=True)
    assert mask == jnet.trainable_mask(jlora, ortho_up=True)
    assert all(not e["up"] and e["down"] and not e["alpha"] for e in mask.values())


def test_ortho_up_draws_on_the_factors_device(tiny):
    """Every draw (down, the normal matrix, the column choice) goes through
    the one generator on the factors' device: a second generator with the
    same seed gives the same tree, another seed another."""
    _, _, tparams, _ = tiny

    def make(seed):
        return tnet.create_slider_network(torch.Generator().manual_seed(seed), tparams, rank=2,
                                          train_method="xattn", ortho_up=True)
    a, b, c = make(5), make(5), make(6)
    for m in a:
        assert torch.equal(a[m]["up"], b[m]["up"]) and torch.equal(a[m]["down"], b[m]["down"])
    assert any(not torch.equal(a[m]["up"], c[m]["up"]) for m in a)


def test_masked_leaf_gets_no_update_or_weight_decay(tiny):
    """AdamW (weight decay 1e-2) with the ortho-up mask: up and the alphas
    stay bit for bit under nonzero gradients, as optax.masked leaves them,
    and down moves as optax moves it (1e-7: f32 sums in another order)."""
    _, jlora, _, tlora = tiny
    mask = jnet.trainable_mask(jlora, ortho_up=True)
    jtx = jopt.make_optimizer("adamw", jopt.make_lr_schedule("constant", 1e-2, 10),
                              trainable_mask=mask)
    ttx = topt.make_optimizer("adamw", topt.make_lr_schedule("constant", 1e-2, 10),
                              trainable_mask=tnet.trainable_mask(tlora, ortho_up=True))
    tw = {m: {k: t.clone() for k, t in e.items()} for m, e in tlora.items()}
    jw, jstate, tstate = jlora, jtx.init(jlora), ttx.init(tw)
    rng = np.random.default_rng(0)
    for _ in range(2):
        g = {m: {k: rng.standard_normal(np.shape(v)).astype(np.float32) for k, v in e.items()}
             for m, e in jlora.items()}
        upd, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jw)
        jw = jax.tree.map(lambda a, b: a + b, jw, upd)
        ttx.update(tw, from_jax_params(g), tstate)
    ref = from_jax_params(_np(jw))
    for m in tw:
        assert torch.equal(tw[m]["up"], tlora[m]["up"]) and torch.equal(ref[m]["up"], tlora[m]["up"])
        assert torch.equal(tw[m]["alpha"], tlora[m]["alpha"])
        assert not torch.equal(tw[m]["down"], tlora[m]["down"])
        torch.testing.assert_close(tw[m]["down"], ref[m]["down"], rtol=0, atol=1e-7)


# -- merge ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_matches_jax(tiny, dtype):
    """merge_lora_weights at multiplier 0.7 against the JAX package's, on the
    TINY FLUX weights in `dtype`: f32 within 1e-6 of the largest weight (the
    rank-4 delta sums in another order); bf16 within one bf16 ulp of each
    weight (the f32 sums may round to neighbouring bf16 values). Gradients
    of a weighted sum of the merged weights with respect to down and up
    against jax.grad through the JAX merge, within 1e-5 relative."""
    params, jlora, _, _ = tiny
    jl = _with_up(jlora, 7)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = jax.tree.map(lambda x: x.astype(jdt), params)
    tp = {k: v.to(tdt) for k, v in pytree.flatten(from_jax_params(_np(params))).items()}
    tp = pytree.unflatten(tp)
    tl = from_jax_params(_np(jl))
    jm = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)),
                      jmerge.merge_lora_weights(jp, jl, 0.7))
    want = pytree.flatten(from_jax_params(jm))
    got = pytree.flatten(tmerge.merge_lora_weights(tp, tl, 0.7))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == tdt
        if dtype == "float32":
            torch.testing.assert_close(g, w, rtol=0, atol=1e-6 * max(1.0, w.abs().max().item()))
        else:
            ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=2.0**-100))) - 7)
            assert ((g.float() - w).abs() <= ulp).all(), k

    rng = np.random.default_rng(8)
    cot = {f"{m}.weight": rng.standard_normal(np.shape(pytree.flatten(params)[f"{m}.weight"]))
           .astype(np.float32) for m in jl}

    def jloss(lw):
        flat = pytree.flatten(jmerge.merge_lora_weights(jp, lw, 0.7))
        return sum(jnp.sum(flat[k].astype(jnp.float32) * c) for k, c in cot.items())

    jgrad = from_jax_params(_np(jax.grad(jloss)(jl)))
    leaves = {m: {k: t.clone().requires_grad_(k != "alpha") for k, t in e.items()}
              for m, e in tl.items()}
    flat = pytree.flatten(tmerge.merge_lora_weights(tp, leaves, 0.7))
    loss = sum((flat[k].float() * torch.from_numpy(c).T).sum() for k, c in cot.items())
    loss.backward()
    for m in tl:
        for k in ("down", "up"):
            want_g = jgrad[m][k]
            scale = max(1e-6, want_g.abs().max().item())
            torch.testing.assert_close(leaves[m][k].grad, want_g, rtol=0, atol=1e-5 * scale)


def test_deltas_and_add_deltas_equal_the_merge(tiny):
    """lora_deltas + add_deltas is the merge split in two (bit for bit)."""
    _, jlora, tparams, _ = tiny
    tl = from_jax_params(_np(_with_up(jlora, 9)))
    merged = pytree.flatten(tmerge.merge_lora_weights(tparams, tl, 1.5))
    split = pytree.flatten(tmerge.add_deltas(tparams, tmerge.lora_deltas(tl, 1.5)))
    for k in merged:
        assert torch.equal(merged[k], split[k])


# -- remat -----------------------------------------------------------------------


def _apply_inputs(cfg, seed=0, B=2, hw=8, L_txt=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, (hw // 2) ** 2, cfg.in_channels)).astype(np.float32)
    return {"x": x, "t": np.array([0.9, 0.4][:B], np.float32),
            "pooled": rng.standard_normal((B, cfg.pooled_projection_dim)).astype(np.float32),
            "ehs": rng.standard_normal((B, L_txt, cfg.joint_attention_dim)).astype(np.float32),
            "g": np.full((B,), 3.5, np.float32), "cot": rng.standard_normal(x.shape)
            .astype(np.float32), "tids": jflux.text_ids(L_txt), "iids": jflux.image_ids(hw, hw)}


def test_apply_remat_matches_no_remat_and_jax(tiny):
    """flux.apply(remat=True) on weights merged from LoRA leaves: the same
    velocity as remat=False (bit for bit) and the same LoRA gradients
    (1e-6 relative: recomputation replays the same ops), and both against
    jax.grad through the JAX package's apply(remat=True) on its merge
    (1e-4 relative: f32 through 2 + 2 blocks)."""
    params, jlora, tparams, _ = tiny
    jl = _with_up(jlora, 10)
    tl = from_jax_params(_np(jl))
    d = _apply_inputs(jflux.TINY)

    def jv(lw):
        p = jmerge.merge_lora_weights(params, lw, 1.0)
        out = jflux.apply(p, jflux.TINY, jnp.asarray(d["x"]), jnp.asarray(d["t"]),
                          jnp.asarray(d["pooled"]), jnp.asarray(d["ehs"]), jnp.asarray(d["tids"]),
                          jnp.asarray(d["iids"]), guidance=jnp.asarray(d["g"]), remat=True)
        return jnp.sum(out * d["cot"]), out

    (_, jout), jgrad = jax.value_and_grad(jv, has_aux=True)(jl)
    jgrad = from_jax_params(_np(jgrad))
    results = {}
    for remat in (False, True):
        leaves = {m: {k: t.clone().requires_grad_(k != "alpha") for k, t in e.items()}
                  for m, e in tl.items()}
        out = flux.apply(tmerge.merge_lora_weights(tparams, leaves, 1.0), flux.TINY,
                         torch.from_numpy(d["x"]), torch.from_numpy(d["t"]),
                         torch.from_numpy(d["pooled"]), torch.from_numpy(d["ehs"]), d["tids"],
                         d["iids"], guidance=torch.from_numpy(d["g"]), remat=remat)
        (out * torch.from_numpy(d["cot"])).sum().backward()
        results[remat] = (out.detach(), leaves)
    assert torch.equal(results[True][0], results[False][0])
    scale = max(1.0, float(np.abs(np.asarray(jout)).max()))
    np.testing.assert_allclose(results[True][0].numpy(), np.asarray(jout), rtol=0,
                               atol=1e-4 * scale)
    for m in tl:
        for k in ("down", "up"):
            a, b = results[True][1][m][k].grad, results[False][1][m][k].grad
            gscale = max(1e-6, jgrad[m][k].abs().max().item())
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * gscale)
            torch.testing.assert_close(a, jgrad[m][k], rtol=0, atol=1e-4 * gscale)


# -- the step ---------------------------------------------------------------------


def _raw_pairs(cfg, n_pairs=2, L=5, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_pairs):
        p = {}
        for role in tfs.ROLES:
            p[f"{role}_t5"] = rng.standard_normal((L, cfg.joint_attention_dim)).astype(np.float32)
            p[f"{role}_pooled"] = rng.standard_normal((cfg.pooled_projection_dim,)).astype(
                np.float32)
        p["guidance_signed"] = np.float32(2.0 if i == 0 else -1.0)
        out.append(p)
    return out


def _jax_draws(state, n_pairs, n_steps, shape):
    """The draws of the JAX step, recomputed from its key exactly as
    flux_slider.py:116-128 make them."""
    key = jax.random.fold_in(state.key, state.step)
    k_pair, k_t, k_lat = jax.random.split(key, 3)
    idx = jax.random.randint(k_pair, (), 0, n_pairs)
    t_to = jax.random.randint(k_t, (), 1, n_steps)
    return int(idx), int(t_to), np.array(jax.random.normal(k_lat, shape))


@pytest.fixture(scope="module")
def jax_step(tiny):
    """The JAX step, built and compiled once for the module."""
    _, lora, _, _ = tiny
    mask = jnet.trainable_mask(lora, ortho_up=True)
    tx = jopt.make_optimizer("adamw", jopt.make_lr_schedule("constant", LR, 100),
                             trainable_mask=mask)
    step = jfs.make_flux_slider_step(
        jflux.TINY, js.make_flowmatch_sampler(num_steps=N_STEPS, mu=0.5), tx, resolution=64,
        batch_size=1, compute_dtype=jnp.float32, remat=False, donate=False, trainable_mask=mask)
    return step, tx, mask


def _port_step(tlora, remat=True, lr=LR, ortho=True):
    mask = tnet.trainable_mask(tlora, ortho_up=ortho)
    tx = topt.make_optimizer("adamw", topt.make_lr_schedule("constant", lr, 100),
                             trainable_mask=mask)
    step = tfs.make_flux_slider_step(
        flux.TINY, ts.make_flowmatch_sampler(num_steps=N_STEPS, mu=0.5), tx, resolution=64,
        batch_size=1, compute_dtype=torch.float32, remat=remat, trainable_mask=mask)
    w = {m: {k: t.clone() for k, t in e.items()} for m, e in tlora.items()}
    return step, tts.SliderTrainState.create(0, w, tx)


def test_step_matches_jax(tiny, jax_step):
    """Two steps of the port (remat on) against JAX make_flux_slider_step
    (remat off) on the same weights and JAX's draws: the loss within 1e-5
    relative, every `down` within 1e-5, `up` and the alphas bit for bit
    (frozen by the mask)."""
    params, lora, tparams, tlora = tiny
    jstep, jtx, _ = jax_step
    raw = _raw_pairs(jflux.TINY)
    jpairs = jts.stack_prompt_pairs([{k: jnp.asarray(v) for k, v in p.items()} for p in raw])
    tpairs = tts.stack_prompt_pairs(raw)
    jstate = jts.SliderTrainState.create(jax.random.key(2), lora, jtx)
    tstep, tstate = _port_step(tlora)
    for _ in range(2):
        draws = _jax_draws(jstate, len(raw), N_STEPS, (1, 16, jflux.TINY.in_channels))
        jstate, jm = jstep(jstate, params, jpairs)
        tstate, tm = tstep(tstate, tparams, tpairs, draws=draws)
        assert (tm["pair"], tm["t_to"]) == (int(jm["pair"]), int(jm["t_to"])) == draws[:2]
        assert tm["phase_ms"] is None  # device times exist only on CUDA
        assert tm["loss"] == pytest.approx(float(jm["loss"]), rel=1e-5)
        ref = from_jax_params(_np(jstate.lora))
        for m in ref:
            np.testing.assert_allclose(tstate.lora[m]["down"].numpy(), ref[m]["down"].numpy(),
                                       rtol=0, atol=1e-5)
            assert torch.equal(tstate.lora[m]["up"], ref[m]["up"])
            assert torch.equal(tstate.lora[m]["up"], tlora[m]["up"])
            assert torch.equal(tstate.lora[m]["alpha"], ref[m]["alpha"])
    assert tstate.step == int(jstate.step) == 2


def test_step_remat_equals_no_remat(tiny):
    """remat recomputes the blocks in the backward: loss, grad norm and the
    updated down are the same (f32, same draws)."""
    _, _, tparams, tlora = tiny
    pairs = tts.stack_prompt_pairs(_raw_pairs(flux.TINY, n_pairs=1))
    draws = tts.step_draws(0, 0, 1, N_STEPS, (1, 16, flux.TINY.in_channels), 1.0)
    (s_off, st_off), (s_on, st_on) = _port_step(tlora, remat=False), _port_step(tlora)
    st_off, m_off = s_off(st_off, tparams, pairs, draws=draws)
    st_on, m_on = s_on(st_on, tparams, pairs, draws=draws)
    assert m_on["loss"] == pytest.approx(m_off["loss"], rel=1e-6)
    assert m_on["grad_norm"] == pytest.approx(m_off["grad_norm"], rel=1e-6)
    for m in st_on.lora:
        np.testing.assert_allclose(st_on.lora[m]["down"].numpy(), st_off.lora[m]["down"].numpy(),
                                   rtol=0, atol=1e-7)


def test_twenty_steps_loss_falls(tiny):
    """As tests/test_flux.py:103-135 holds the JAX step: a rank-2 xattn
    slider (no ortho-up) at lr 5e-3 on the same draws every step; the loss
    falls."""
    _, _, tparams, _ = tiny
    lora = tnet.create_slider_network(torch.Generator().manual_seed(1), tparams, rank=2,
                                      train_method="xattn")
    step, state = _port_step(lora, remat=False, lr=5e-3, ortho=False)
    pairs = tts.stack_prompt_pairs(_raw_pairs(flux.TINY, n_pairs=1))
    losses = []
    for _ in range(20):
        state.step = 0
        state, m = step(state, tparams, pairs)
        losses.append(m["loss"])
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], (losses[0], losses[-1])


@pytest.mark.parametrize("kw,item", [({"mesh": object()}, "item 15"),
                                     ({"pp_microbatches": 2}, "item 15"),
                                     ({"chunk": 2}, "item 18")])
def test_step_variants_not_ported_raise(tiny, kw, item):
    _, _, _, tlora = tiny
    tx = topt.make_optimizer("adamw", lambda s: LR)
    with pytest.raises(NotImplementedError, match=item):
        tfs.make_flux_slider_step(flux.TINY, ts.make_flowmatch_sampler(2, mu=0.5), tx, **kw)


# -- the CLI ----------------------------------------------------------------------


def test_cli_end_to_end(tmp_path, capsys):
    """The tiny FLUX snapshot through the port's CLI on the CPU with
    tests/test_flux_cli.py's config and assertions: the JAX CLI's stdout
    lines, the `_2steps` save (steps_per_call 2 changes nothing), `_last`
    with finite factors, and the metadata sidecar."""
    snap = make_tiny_flux_snapshot(str(tmp_path / "flux_tiny"))
    prompts = tmp_path / "prompts.yaml"
    prompts.write_text(
        "- target: person\n  positive: very old person\n  unconditional: ''\n"
        "  neutral: person\n  action: enhance\n  guidance_scale: 1\n"
        "  resolution: 64\n  batch_size: 1\n"
    )
    cfg = tmp_path / "config.yaml"
    cfg.write_text(
        f"""
prompts_file: "{prompts}"
pretrained_model:
  name_or_path: "{snap}"
network:
  type: lierla
  rank: 2
  alpha: 1.0
  training_method: xattn
train:
  precision: float32
  iterations: 5
  lr: 0.0002
  optimizer: adamw
  lr_scheduler: constant
  max_denoising_steps: 3
save:
  name: flux_tiny_slider
  path: "{tmp_path / 'out'}"
  per_steps: 2
logging:
  log_every: 1
tpu:
  remat: false
  steps_per_call: 2
"""
    )
    args = tcli.build_parser().parse_args(
        ["--config_file", str(cfg), "--t5_len", "16", "--seed", "1", "--device", "cpu"])
    final = tcli.main(args)
    lines = capsys.readouterr().out.splitlines()
    assert "create LoRA for transformer: 22 modules (ortho_up=True)." in lines
    assert [ln.split(":")[0] for ln in lines if ln.startswith("step ")] == [
        f"step {i}" for i in range(5)]
    assert lines[-1] == "Done."

    name = "flux_tiny_slider_alpha1.0_rank2_xattn"
    out = tmp_path / "out" / name
    assert sorted(p.name for p in out.iterdir()) == sorted(
        f"{name}{s}" for s in ("_2steps.safetensors", "_last.safetensors", "_metadata.json"))
    md = json.loads((out / f"{name}_metadata.json").read_text())
    assert md["config"]["network"]["rank"] == 2
    state = read_safetensors(str(out / f"{name}_last.safetensors"))
    downs = [k for k in state if k.endswith("lora_down.weight")]
    assert len(downs) == 22 and all(torch.isfinite(v).all() for v in state.values())
    assert all(torch.isfinite(t).all() for e in final.values() for t in e.values())


def test_cli_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = tmp_path / "config.yaml"
    (tmp_path / "p.yaml").write_text("- target: person\n  positive: old person\n")
    cfg.write_text(f"prompts_file: {tmp_path / 'p.yaml'}\n"
                   f"pretrained_model:\n  name_or_path: {tmp_path / 'absent'}\n")
    with pytest.raises(RuntimeError, match="none is available"):
        tcli.main(tcli.build_parser().parse_args(["--config_file", str(cfg)]))
