"""The port's image-slider fleet step (`training/fleet.make_fleet_image_step`)
on the CPU: K = 2 image sliders against the JAX package's fleet image step
on the same weights, images and draws (SD's TINY UNet and TINY_XL, the TINY
VAE), and each row against the port's solo image step run with seed
`fleet_row_seed(seed, r)`.

As `tests/test_torch_image_slider.py`: f32 at 32 px with lr 1e-4, the LoRA
held within atol 1e-5 (Adam turns ULP-level gradient noise on the
zero-initialised up factors into lr-sized steps, so the bound is
meaningful only at a small lr) and the losses within 1e-5 relative.
"""

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
from sliders_tpu.models import vae as jvae
from sliders_tpu.training import fleet as jfleet
from sliders_tpu.training import optimizers as jopt
from sliders_tpu.training.text_slider import SliderTrainState as JaxState
from sliders_tpu_torch.diffusion import schedulers as tsched
from sliders_tpu_torch.lora import network as tnet
from sliders_tpu_torch.models import unet2d as tunet
from sliders_tpu_torch.models import vae as tvae
from sliders_tpu_torch.models.convert import from_jax_params
from sliders_tpu_torch.training import fleet as tfleet
from sliders_tpu_torch.training import image_slider as tis
from sliders_tpu_torch.training import optimizers as topt
from sliders_tpu_torch.training.text_slider import SliderTrainState

MAX_STEPS = 10
LR = 1e-4
K = 2


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


def _batch(xl: bool, seed: int = 4) -> dict:
    """K pairs of uint8 images (as the CLI quantises them) and the prompt
    embeddings with the leading (K,) axis, as numpy."""
    rng = np.random.default_rng(seed)
    b = {"images_low": rng.integers(0, 200, (K, 1, 32, 32, 3), dtype=np.uint8),
         "images_high": rng.integers(50, 256, (K, 1, 32, 32, 3), dtype=np.uint8),
         "positive": rng.standard_normal((K, 7, 32)).astype(np.float32),
         "neutral": rng.standard_normal((K, 7, 32)).astype(np.float32)}
    if xl:
        b["pooled_positive"] = rng.standard_normal((K, 16)).astype(np.float32)
        b["pooled_neutral"] = rng.standard_normal((K, 16)).astype(np.float32)
        b["time_ids"] = np.tile(np.array([32, 32, 0, 0, 32, 32], np.float32), (K, 1))
    return b


def _jax_fleet_draws(fleet_key, step, B=1, latent_hw=(16, 16)):
    """The JAX fleet image step's per-row draws, recomputed from its keys as
    fleet.py:616-644 makes them."""
    rows = []
    for r in range(K):
        key = jax.random.fold_in(jax.random.fold_in(fleet_key, r), step)
        k_t, k_post, k_noise = jax.random.split(key, 3)
        t_to = int(jax.random.randint(k_t, (), 1, MAX_STEPS - 1))
        eps = jax.random.normal(k_post, (2 * B, *latent_hw, 4), jnp.float32)
        noise = jax.random.normal(k_noise, (B, *latent_hw, 4), jnp.float32)
        rows.append((t_to, torch.from_numpy(np.array(eps)), torch.from_numpy(np.array(noise))))
    return rows


def _topt(lora):
    return topt.make_optimizer("adamw", topt.make_lr_schedule("constant", LR, 100),
                               trainable_mask=tnet.trainable_mask(lora))


@pytest.mark.parametrize("xl", [False, True], ids=["sd", "xl"])
def test_fleet_image_step_matches_jax(xl):
    """Three steps at per-row scales (1, 2), (2, 1), (1, 1) of the port's
    fleet image step against the JAX fleet image step on the JAX draws:
    per-row t_to and scale equal, per-row losses within 1e-5 relative, the
    LoRA after each update within atol 1e-5, the alphas bit for bit."""
    ucfg, tucfg = (junet.TINY_XL, tunet.TINY_XL) if xl else (junet.TINY, tunet.TINY)
    uparams = junet.init_params(jax.random.key(0), ucfg)
    vparams = jvae.init_params(jax.random.key(1), jvae.TINY)
    loras = [jnet.create_slider_network(jax.random.key(2 + r), uparams, rank=2,
                                        train_method="noxattn", init_a=math.sqrt(5))
             for r in range(K)]
    fleet = jfleet.stack_fleet(loras)
    jtx = jopt.make_optimizer("adamw", jopt.make_lr_schedule("constant", LR, 100),
                              trainable_mask=jnet.trainable_mask(fleet))
    sched = jmake_schedule()
    jstep = jfleet.make_fleet_image_step(
        ucfg, jvae.TINY, sched, jmake_sampler(sched, "ddim", MAX_STEPS), jtx, n_sliders=K,
        max_denoising_steps=MAX_STEPS, compute_dtype=jnp.float32, remat=False, is_xl=xl,
        donate=False)
    fleet_key = jax.random.key(3)
    jstate = JaxState.create(fleet_key, fleet, jtx)

    tlora = tfleet.stack_fleet([from_jax_params(_np(w)) for w in loras])
    ttx = _topt(tlora)
    tsch = tsched.make_schedule()
    tstep = tfleet.make_fleet_image_step(
        tucfg, tvae.TINY, tsch, tsched.make_sampler(tsch, "ddim", MAX_STEPS), ttx, n_sliders=K,
        max_denoising_steps=MAX_STEPS, compute_dtype=torch.float32, remat=False, is_xl=xl)
    tstate = SliderTrainState.create(0, tlora, ttx)
    tu, tv = from_jax_params(_np(uparams)), from_jax_params(_np(vparams))

    nb = _batch(xl)
    tbatch = {k: torch.from_numpy(v) for k, v in nb.items()}
    for step, scales in enumerate(((1.0, 2.0), (2.0, 1.0), (1.0, 1.0))):
        draws = _jax_fleet_draws(fleet_key, step)
        sc = np.asarray(scales, np.float32)
        jstate, jm = jstep(jstate, uparams, vparams,
                           {**{k: jnp.asarray(v) for k, v in nb.items()},
                            "scale": jnp.asarray(sc)})
        tstate, tm = tstep(tstate, tu, tv, {**tbatch, "scale": torch.from_numpy(sc)},
                           draws=draws)
        assert tm["t_to"] == np.asarray(jm["t_to"]).tolist() == [d[0] for d in draws]
        assert tm["scale"] == list(scales) and tm["phase_ms"] is None
        np.testing.assert_allclose(tm["loss"], np.asarray(jm["loss"]), rtol=1e-5)
        ref = from_jax_params(_np(jstate.lora))
        for m in ref:
            for k in ("down", "up"):
                np.testing.assert_allclose(tstate.lora[m][k].numpy(), ref[m][k].numpy(),
                                           rtol=0, atol=1e-5)
            assert torch.equal(tstate.lora[m]["alpha"], ref[m]["alpha"])
    assert tstate.step == int(jstate.step) == 3


def test_fleet_image_rows_equal_solo_steps():
    """Row r of a port fleet run with seed s, on its own draws, is the
    port's solo image step run with seed `fleet_row_seed(s, r)` on row r's
    images and scale: t_to equal, losses within 1e-5 relative, the LoRA
    within atol 1e-5 after three steps."""
    uparams = tunet.init_params(torch.Generator().manual_seed(0), tunet.TINY)
    vparams = tvae.init_params(torch.Generator().manual_seed(1), tvae.TINY)
    seed = 21
    rows = [tnet.create_slider_network(torch.Generator().manual_seed(
        tfleet.fleet_row_seed(seed, r) + 1), uparams, rank=2, train_method="noxattn",
        init_a=math.sqrt(5)) for r in range(K)]
    sch = tsched.make_schedule()
    sampler = tsched.make_sampler(sch, "lms", MAX_STEPS)
    flora = tfleet.stack_fleet(rows)
    ftx = _topt(flora)
    fstep = tfleet.make_fleet_image_step(tunet.TINY, tvae.TINY, sch, sampler, ftx, n_sliders=K,
                                         max_denoising_steps=MAX_STEPS,
                                         compute_dtype=torch.float32, remat=False)
    fstate = SliderTrainState.create(seed, flora, ftx)
    batch = {k: torch.from_numpy(v) for k, v in _batch(False, seed=5).items()}
    scales = [(2.0, 1.0), (1.0, 2.0), (2.0, 2.0)]
    fms = []
    for sc in scales:
        fstate, m = fstep(fstate, uparams, vparams, {**batch, "scale": torch.tensor(sc)})
        fms.append(m)
    out = tfleet.unstack_fleet(fstate.lora)
    for r in range(K):
        lora = {m: {k: t.clone() for k, t in e.items()} for m, e in rows[r].items()}
        tx = _topt(lora)
        step = tis.make_image_slider_step(tunet.TINY, tvae.TINY, sch, sampler, tx,
                                          max_denoising_steps=MAX_STEPS,
                                          compute_dtype=torch.float32, remat=False)
        state = SliderTrainState.create(tfleet.fleet_row_seed(seed, r), lora, tx)
        solo = {k: v[r] for k, v in batch.items()}
        for sc, fm in zip(scales, fms):
            state, m = step(state, uparams, vparams, {**solo, "scale": sc[r]})
            assert m["t_to"] == fm["t_to"][r] and m["scale"] == fm["scale"][r]
            assert m["loss"] == pytest.approx(fm["loss"][r], rel=1e-5)
            assert m["grad_norm"] == pytest.approx(fm["grad_norm"][r], rel=1e-5)
        for mod in lora:
            for k in ("down", "up", "alpha"):
                np.testing.assert_allclose(out[r][mod][k].numpy(), state.lora[mod][k].numpy(),
                                           rtol=0, atol=1e-5)
