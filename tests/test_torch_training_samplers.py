"""The port's text-slider training step under every sampler kind against
sliders_tpu's step on the CPU, as
tests/test_vpred_and_schedulers_e2e.py::test_train_step_all_schedulers runs
the JAX step: (ddim, v_prediction), (euler_a, epsilon), (lms, epsilon) and
(ddpm, epsilon).

The TINY UNet runs in f32 at 64 px on the same weights, with the JAX
step's draws passed in: the pair, t_to and latents,
and for ddpm and euler_a the denoise loop's per-step ancestral noise
normal(fold_in(k_anc, i)), which the port takes as the fifth entry of its
draws. lr is 1e-4, as in tests/test_torch_training.py, where Adam's
amplification of ULP-level gradient noise leaves atol 1e-5 meaningful on
the LoRA. Each JAX step compiles once per case (about 10 s), so the image
step's cases are in tests/test_torch_image_step_samplers.py."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_tpu.diffusion import make_sampler as jmake_sampler
from sliders_tpu.diffusion import make_schedule as jmake_schedule
from sliders_tpu.lora import network as jnet
from sliders_tpu.models import unet2d as junet
from sliders_tpu.training import optimizers as jopt
from sliders_tpu.training import text_slider as jts
from sliders_tpu_torch.diffusion import schedulers as tsched
from sliders_tpu_torch.lora import network as tnet
from sliders_tpu_torch.models import unet2d as tunet
from sliders_tpu_torch.models.convert import from_jax_params
from sliders_tpu_torch.training import optimizers as topt
from sliders_tpu_torch.training import text_slider as tts

KINDS = [("ddim", "v_prediction"), ("euler_a", "epsilon"), ("lms", "epsilon"),
         ("ddpm", "epsilon")]
MAX_STEPS = 5
LR = 1e-4
ATOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    params = junet.init_params(jax.random.key(0), junet.TINY)
    lora = jnet.create_slider_network(jax.random.key(1), params, rank=2, alpha=1.0,
                                      train_method="noxattn")
    return params, lora, from_jax_params(_np(params)), from_jax_params(_np(lora))


def _optimizers(lora, tlora):
    jtx = jopt.make_optimizer("adamw", jopt.make_lr_schedule("constant", LR, 100),
                              trainable_mask=jnet.trainable_mask(lora))
    ttx = topt.make_optimizer("adamw", topt.make_lr_schedule("constant", LR, 100),
                              trainable_mask=tnet.trainable_mask(tlora))
    return jtx, ttx


def _assert_lora(tlora, jlora):
    ref = from_jax_params(_np(jlora))
    for m in ref:
        for k in ("down", "up"):
            np.testing.assert_allclose(tlora[m][k].numpy(), ref[m][k].numpy(), rtol=0,
                                       atol=ATOL, err_msg=f"{m}.{k}")
        assert torch.equal(tlora[m]["alpha"], ref[m]["alpha"])


def _text_draws(state, n_pairs, shape, init_noise_sigma, stochastic):
    """The JAX text step's draws, recomputed from its key as
    text_slider.py:157-163,177-180,213 make them."""
    key = jax.random.fold_in(state.key, state.step)
    k_pair, k_t, k_lat, k_anc, _ = jax.random.split(key, 5)
    idx = int(jax.random.randint(k_pair, (), 0, n_pairs))
    t_to = int(jax.random.randint(k_t, (), 1, MAX_STEPS))
    lat = np.asarray((jax.random.normal(k_lat, shape) * init_noise_sigma).astype(jnp.float32))
    if not stochastic:
        return idx, t_to, torch.from_numpy(lat)
    noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(k_anc, i), shape,
                                                   jnp.float32)) for i in range(t_to)])
    return idx, t_to, torch.from_numpy(lat), None, torch.from_numpy(noise)


def _pairs(D=32, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(2):
        p = {k: rng.standard_normal((7, D)).astype(np.float32)
             for k in ("target", "positive", "neutral", "unconditional")}
        p["guidance_signed"] = np.float32(3.0 if i == 0 else -1.5)
        out.append(p)
    return out


@pytest.mark.parametrize("kind,pred", KINDS)
def test_text_step_matches_jax(tiny, kind, pred):
    """Two iterations: loss and grad_norm within 1e-5, the LoRA within atol
    1e-5 after each update, the alphas bit for bit."""
    params, lora, tparams, tlora = tiny
    jsch, tsch = jmake_schedule(prediction_type=pred), tsched.make_schedule(prediction_type=pred)
    jsamp, tsamp = jmake_sampler(jsch, kind, MAX_STEPS), tsched.make_sampler(tsch, kind,
                                                                              MAX_STEPS)
    jtx, ttx = _optimizers(lora, tlora)
    jstep = jts.make_text_slider_step(junet.TINY, jsch, jsamp, jtx,
                                      max_denoising_steps=MAX_STEPS, resolution=64, batch_size=1,
                                      compute_dtype=jnp.float32, remat=False, donate=False)
    tstep = tts.make_text_slider_step(tunet.TINY, tsch, tsamp, ttx,
                                      max_denoising_steps=MAX_STEPS, resolution=64, batch_size=1,
                                      compute_dtype=torch.float32, remat=False)
    jstate = jts.SliderTrainState.create(jax.random.key(2), lora, jtx)
    tstate = tts.SliderTrainState.create(0, {m: {k: t.clone() for k, t in e.items()} for m, e in tlora.items()}, ttx)
    raw = _pairs()
    jpairs = jts.stack_prompt_pairs([{k: jnp.asarray(v) for k, v in p.items()} for p in raw])
    tpairs = tts.stack_prompt_pairs(raw)
    for _ in range(2):
        draws = _text_draws(jstate, len(raw), (1, 8, 8, 4), float(jsamp.init_noise_sigma),
                            tsamp.stochastic)
        jstate, jm = jstep(jstate, params, jpairs)
        tstate, tm = tstep(tstate, tparams, tpairs, draws=draws)
        assert (tm["pair"], tm["t_to"]) == (int(jm["pair"]), int(jm["t_to"])) == draws[:2]
        assert tm["loss"] == pytest.approx(float(jm["loss"]), abs=ATOL)
        assert tm["grad_norm"] == pytest.approx(float(jm["grad_norm"]), abs=ATOL)
        _assert_lora(tstate.lora, jstate.lora)
    if tsamp.stochastic:  # without the ancestral draws the loop cannot run
        with pytest.raises(ValueError, match="ancestral draws"):
            tstep(tstate, tparams, tpairs, draws=draws[:3])


@pytest.mark.parametrize("kind", ["ddpm", "euler_a"])
def test_text_step_draws_its_own_ancestral_noise(tiny, kind):
    """The step's own draws carry t_to noise tensors, drawn after the
    latents, so the pair, t_to and latents are those of a ddim run."""
    _, _, _, tlora = tiny
    a = tts.step_draws(7, 3, 2, MAX_STEPS, (1, 8, 8, 4), 14.6, ancestral=True)
    d = tts.step_draws(7, 3, 2, MAX_STEPS, (1, 8, 8, 4), 14.6)
    assert a[:2] == d[:2] and torch.equal(a[2], d[2]) and a[3] is None
    assert a[4].shape == (a[1], 1, 8, 8, 4)
    x = tts.step_draws(7, 3, 2, MAX_STEPS, (1, 8, 8, 4), 14.6, crop=True, ancestral=True)
    assert len(x[3]) == 3 and x[4].shape == a[4].shape
    tsch = tsched.make_schedule()
    ttx = topt.make_optimizer("adamw", topt.make_lr_schedule("constant", LR, 100),
                              trainable_mask=tnet.trainable_mask(tlora))
    step = tts.make_text_slider_step(tunet.TINY, tsch, tsched.make_sampler(tsch, kind, MAX_STEPS),
                                     ttx, max_denoising_steps=MAX_STEPS, resolution=64,
                                     compute_dtype=torch.float32, remat=False)
    state = tts.SliderTrainState.create(7, {m: {k: t.clone() for k, t in e.items()} for m, e in tlora.items()}, ttx)
    params = tunet.init_params(torch.Generator().manual_seed(0), tunet.TINY)
    state, m = step(state, params, tts.stack_prompt_pairs(_pairs()))
    assert math.isfinite(m["loss"]) and state.step == 1
