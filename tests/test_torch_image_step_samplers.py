"""The port's image-slider training step under every sampler kind against
sliders_tpu's step on the CPU: (ddim, v_prediction), (euler_a, epsilon),
(lms, epsilon) and (ddpm, epsilon), as
tests/test_vpred_and_schedulers_e2e.py::test_train_step_all_schedulers runs
the JAX text step. The step never calls `sampler.step`; the kind sets the
1000-grid input scale and the 50-grid timestep the noise goes in at, which
lms and euler_a take from linspace floats, truncated as the JAX step's
astype(int32) does. TINY UNet and TINY VAE in f32 at 32 px, on the same
weights and the JAX step's draws; lr 1e-4 and atol 1e-5 on the LoRA, as in
tests/test_torch_image_slider.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_training_samplers import KINDS, _assert_lora, _np, _optimizers, tiny  # noqa: F401

from sliders_tpu.diffusion import make_sampler as jmake_sampler
from sliders_tpu.diffusion import make_schedule as jmake_schedule
from sliders_tpu.models import unet2d as junet
from sliders_tpu.models import vae as jvae
from sliders_tpu.training import image_slider as jis
from sliders_tpu.training import text_slider as jts
from sliders_tpu_torch.diffusion import schedulers as tsched
from sliders_tpu_torch.models import unet2d as tunet
from sliders_tpu_torch.models import vae as tvae
from sliders_tpu_torch.models.convert import from_jax_params
from sliders_tpu_torch.training import image_slider as tis
from sliders_tpu_torch.training import text_slider as tts

# 8 steps: linspace(0, 999, 8) holds non-integer timesteps at every t_to
MAX_STEPS = 8


def _image_batch(seed=4):
    rng = np.random.default_rng(seed)
    return {"images_low": rng.integers(0, 200, (1, 32, 32, 3), dtype=np.uint8),
            "images_high": rng.integers(50, 256, (1, 32, 32, 3), dtype=np.uint8),
            "positive": rng.standard_normal((7, 32)).astype(np.float32),
            "neutral": rng.standard_normal((7, 32)).astype(np.float32)}


@pytest.mark.parametrize("kind,pred", KINDS)
def test_image_step_matches_jax(tiny, kind, pred):
    """One iteration at scale 2 with the JAX step's draws: the loss within
    1e-5 relative, the LoRA within atol 1e-5. Under lms and euler_a the
    noise goes in at the truncated linspace timestep, as in JAX."""
    params, lora, tparams, tlora = tiny
    vparams = jvae.init_params(jax.random.key(1), jvae.TINY)
    jsch, tsch = jmake_schedule(prediction_type=pred), tsched.make_schedule(prediction_type=pred)
    max_steps = MAX_STEPS
    jsamp = jmake_sampler(jsch, kind, max_steps)
    tsamp = tsched.make_sampler(tsch, kind, max_steps)
    jtx, ttx = _optimizers(lora, tlora)
    jstep = jis.make_image_slider_step(junet.TINY, jvae.TINY, jsch, jsamp, jtx,
                                       max_denoising_steps=max_steps, compute_dtype=jnp.float32,
                                       remat=False, donate=False)
    tstep = tis.make_image_slider_step(tunet.TINY, tvae.TINY, tsch, tsamp, ttx,
                                       max_denoising_steps=max_steps, compute_dtype=torch.float32,
                                       remat=False)
    jstate = jts.SliderTrainState.create(jax.random.key(3), lora, jtx)
    tstate = tts.SliderTrainState.create(0, {m: {k: t.clone() for k, t in e.items()} for m, e in tlora.items()}, ttx)
    key = jax.random.fold_in(jstate.key, jstate.step)
    k_t, k_post, k_noise = jax.random.split(key, 3)
    t_to = int(jax.random.randint(k_t, (), 1, max_steps - 1))
    draws = (t_to, torch.from_numpy(np.array(jax.random.normal(k_post, (2, 16, 16, 4)))),
             torch.from_numpy(np.array(jax.random.normal(k_noise, (1, 16, 16, 4)))))
    nb = _image_batch()
    jstate, jm = jstep(jstate, params, vparams, {**{k: jnp.asarray(v) for k, v in nb.items()},
                                                 "scale": jnp.asarray(2.0, jnp.float32)})
    tstate, tm = tstep(tstate, tparams, from_jax_params(_np(vparams)),
                       {**{k: torch.from_numpy(v) for k, v in nb.items()}, "scale": 2.0},
                       draws=draws)
    assert tm["t_to"] == int(jm["t_to"]) == t_to
    assert tm["loss"] == pytest.approx(float(jm["loss"]), rel=1e-5)
    _assert_lora(tstate.lora, jstate.lora)
    if kind in ("lms", "euler_a"):
        assert float(tsamp.timesteps[t_to]) != int(tsamp.timesteps[t_to])
