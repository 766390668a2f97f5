"""Real-image editing in the port against sliders_tpu on the CPU:
`pipelines/inversion.py`'s DDIM inversion, null-text optimiser and edit
sampling (per-row and scalar merged scales) on TINY with shared weights
(`from_jax_params`), in f32, 4 DDIM steps. `edit_image` end to end is in
tests/test_torch_edit_image.py (each JAX program compiles for seconds, so
the two files run in parallel).

Tolerance: 1e-5 of the largest value (REL, as tests/test_torch_sampling.py).
The null-text optimiser is held in its two break cases, which keep the
data-dependent break away from its threshold on both sides: epsilon 0 (no
loss passes below it: every inner step runs) and epsilon 1e3 (every loss
does: one update a step). Adam divides each gradient element by its own
running magnitude, so elements whose gradient nearly cancels carry the two
packages' f32 sums' relative error (up to 1e-3 there, 3.5e-6 of the largest
gradient) into updates of about lr each: three updates at the notebook's lr
1e-2 reach 5e-5 of the largest embedding value. The case that runs every
inner step therefore takes base_lr 1e-3; one wrong or missing update would
still move elements by about 1e-3, 140 times the tolerance.
`adam_step` itself is held to optax.adam on the same gradients at 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sliders_tpu.diffusion import make_sampler as jmake_sampler
from sliders_tpu.diffusion import make_schedule as jmake_schedule
from sliders_tpu.lora import network as jnet
from sliders_tpu.models import unet2d as junet
from sliders_tpu.pipelines import inversion as jinv
from sliders_tpu_torch.diffusion import make_sampler, make_schedule
from sliders_tpu_torch.models import unet2d as tunet
from sliders_tpu_torch.models.convert import from_jax_params
from sliders_tpu_torch.pipelines import inversion as tinv

REL = 1e-5
STEPS = 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _slider(params, key):
    w = jnet.create_slider_network(jax.random.key(key), params, rank=2, train_method="noxattn")
    ks = iter(jax.random.split(jax.random.key(key + 100), len(w)))
    return {m: {**e, "up": jax.random.normal(next(ks), e["up"].shape) * 0.3}
            for m, e in w.items()}


def _close(out, ref, rel=REL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out.float()), ref, rtol=0,
                               atol=rel * float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def setup():
    params = junet.init_params(jax.random.key(0), junet.TINY)
    rng = np.random.default_rng(1)
    cond, uncond = ((rng.standard_normal((1, 7, 32)) * 0.2).astype(np.float32) for _ in range(2))
    clean = (rng.standard_normal((1, 8, 8, 4)) * 0.3).astype(np.float32)
    js = jmake_sampler(jmake_schedule(), "ddim", STEPS)
    ts = make_sampler(make_schedule(), "ddim", STEPS)
    traj = jinv.make_ddim_inversion_fn(junet.TINY, js)(params, clean, cond)
    return dict(params=params, tparams=from_jax_params(_np(params)), cond=cond, uncond=uncond,
                clean=clean, js=js, ts=ts, traj=np.asarray(traj))


def test_inversion_trajectory_matches_jax(setup):
    """(n + 1, B, ...) with traj[0] = x_T and traj[n] the clean latents."""
    traj = tinv.make_ddim_inversion_fn(tunet.TINY, setup["ts"])(
        setup["tparams"], torch.tensor(setup["clean"]), torch.tensor(setup["cond"]))
    assert traj.shape == (STEPS + 1, 1, 8, 8, 4)
    _close(traj, setup["traj"])
    assert torch.equal(traj[-1], torch.tensor(setup["clean"]))


@pytest.mark.parametrize("epsilon,base_lr,inner", [(0.0, 1e-3, 3), (1e3, 1e-2, 1)],
                         ids=["every-inner-step", "break-after-the-first"])
def test_null_text_matches_jax(setup, epsilon, base_lr, inner):
    """The per-step optimised uncond embeddings on JAX's trajectory, and the
    number of updates each step took (all 3, or 1 after the break)."""
    kw = dict(guidance_scale=7.5, num_inner_steps=3, base_lr=base_lr, epsilon=epsilon)
    ref = jinv.make_null_text_optimizer(junet.TINY, setup["js"], **kw)(
        setup["params"], jnp.asarray(setup["traj"]), setup["cond"], setup["uncond"])
    steps = {}
    out = tinv.make_null_text_optimizer(
        tunet.TINY, setup["ts"], on_step=lambda i, losses: steps.setdefault(i, losses), **kw)(
        setup["tparams"], torch.tensor(setup["traj"]), torch.tensor(setup["cond"]),
        torch.tensor(setup["uncond"]))
    assert out.shape == (STEPS, 1, 7, 32)
    assert [len(steps[i]) for i in range(STEPS)] == [inner] * STEPS
    assert all(loss > 0 for losses in steps.values() for loss in losses)
    _close(out, ref)
    assert float((out - torch.tensor(setup["uncond"])).abs().max()) > 0.5 * base_lr


def test_adam_step_matches_optax():
    """`adam_step` against optax.adam on the same four gradients, lr as the
    optimiser's at step 3: f32 within 1e-6 of the largest value."""
    rng = np.random.default_rng(4)
    u0 = rng.standard_normal((2, 5, 8)).astype(np.float32)
    grads = [(rng.standard_normal(u0.shape) * 10.0 ** rng.uniform(-4, 0, u0.shape))
             .astype(np.float32) for _ in range(4)]
    lr = np.float32(1e-2) * (np.float32(1.0) - np.float32(3) / np.float32(100.0))
    tx = optax.adam(lr)
    ju, jstate = jnp.asarray(u0), tx.init(jnp.asarray(u0))
    u = torch.tensor(u0)
    m, v = torch.zeros_like(u), torch.zeros_like(u)
    for count, g in enumerate(grads, 1):
        upd, jstate = tx.update(jnp.asarray(g), jstate, ju)
        ju = optax.apply_updates(ju, upd)
        u, m, v = tinv.adam_step(u, torch.tensor(g), m, v, count, float(lr))
        _close(u - torch.tensor(u0), np.asarray(ju) - u0, 1e-6)


@pytest.mark.parametrize("vector", [True, False], ids=["per-row-scales", "scalar-merged"])
def test_edit_sampling_matches_jax(setup, vector):
    """CFG sampling from x_T (unit normal, the noise level of DDIM's first
    step) on per-step uncond embeddings with a slider gated at start_noise
    500 (off for the first of 4 DDIM steps, t = 750): the sweep (0, 2) as
    one batch of per-row multipliers, or scale 2 on the merged weights."""
    params, tparams, js, ts = (setup[k] for k in ("params", "tparams", "js", "ts"))
    rng = np.random.default_rng(5)
    w = _slider(params, 7)
    tw = from_jax_params(_np(w))
    B = 2 if vector else 1
    x_T = np.repeat(rng.standard_normal((1, 8, 8, 4)).astype(np.float32), B, axis=0)
    cond = np.repeat((rng.standard_normal((1, 7, 32)) * 0.2).astype(np.float32), B, axis=0)
    per_step = (rng.standard_normal((STEPS, B, 7, 32)) * 0.2).astype(np.float32)
    scale = np.array([0.0, 2.0], np.float32) if vector else np.float32(2.0)
    ref = jinv.make_edit_sampling_fn(junet.TINY, js, guidance_scale=7.5)(
        params, x_T, cond, per_step, w, jnp.asarray(scale), jnp.asarray(500.0))
    edit = tinv.make_edit_sampling_fn(tunet.TINY, ts, guidance_scale=7.5)
    out = edit(tparams, torch.tensor(x_T), torch.tensor(cond), torch.tensor(per_step), tw,
               torch.tensor(scale), 500.0)
    _close(out, ref)
    base = edit(tparams, torch.tensor(x_T), torch.tensor(cond), torch.tensor(per_step), None,
                0.0, 500.0)
    assert float((out[-1] - base[-1]).abs().max()) > 1e-3, "the slider did nothing"
