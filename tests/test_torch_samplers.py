"""Parity of the port's DDPM, LMS and Euler-ancestral samplers with
sliders_tpu on the CPU, and the closed-form goldens of tests/test_schedulers.py
held on the port.

The tables come from the same f64 numpy and are rounded once to f32 on both
sides, so they are compared bit for bit. Steps are elementwise f32 arithmetic
in the same order; LMS's update is a 4-term dot product whose order of sums
may differ, so steps are held at 1e-6 relative to the largest value. Every
ancestral step takes the same injected noise on both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_tpu.diffusion import make_sampler as jmake_sampler
from sliders_tpu.diffusion import make_schedule as jmake_schedule
from sliders_tpu.diffusion import schedulers as js
from sliders_tpu_torch.diffusion import make_sampler, make_schedule
from sliders_tpu_torch.diffusion import schedulers as ts

KINDS = ["ddim", "ddpm", "lms", "euler_a"]
PREDS = ["epsilon", "v_prediction"]


def _close(out, ref, rel=1e-6):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=rel * scale)


def _pair(kind, steps, pred="epsilon"):
    return (jmake_sampler(jmake_schedule(prediction_type=pred), kind, steps),
            make_sampler(make_schedule(prediction_type=pred), kind, steps))


@pytest.mark.parametrize("steps", [50, 10, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_tables_equal_jax_bit_for_bit(kind, steps):
    jsamp, tsamp = _pair(kind, steps)
    assert tsamp.kind == kind and tsamp.num_steps == steps
    for field in ("timesteps", "alpha_prod", "alpha_prod_prev", "ddpm_variance", "sigmas",
                  "lms_coeffs"):
        jv, tv = getattr(jsamp, field), getattr(tsamp, field)
        assert (jv is None) == (tv is None), field
        if tv is not None:
            assert tv.dtype == torch.float32
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv), err_msg=field)
    assert tsamp.init_noise_sigma == float(jsamp.init_noise_sigma)
    if kind in ("lms", "euler_a"):
        assert 14.0 < tsamp.init_noise_sigma < 15.0
    assert tsamp.stochastic == (kind in ("ddpm", "euler_a"))


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="Unknown scheduler"):
        make_sampler(make_schedule(), "dpm++", 10)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("pred", PREDS)
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("kind", ["ddpm", "euler_a"])
def test_ancestral_step_matches_jax(kind, per_row, pred):
    """One step at early, middle and late positions with the same injected
    noise; per-row rows sit at different positions. The JAX ddpm's last-step
    test broadcasts a per-row flag against the channel axis, so per-row rows
    here stay off the last step (its own test below)."""
    n = 20
    jsamp, tsamp = _pair(kind, n, pred)
    x, eps, noise = _inputs((4, 5, 5, 4), 0)
    for i in (0, 9, n - 2):
        idx = np.array([i, max(i - 3, 0), min(i + 1, n - 2), 4]) if per_row else i
        ref, _ = jsamp.step(jnp.asarray(idx), jnp.asarray(eps), jnp.asarray(x), {},
                            noise=jnp.asarray(noise))
        out, _ = tsamp.step(torch.as_tensor(idx), torch.from_numpy(eps), torch.from_numpy(x),
                            {}, noise=torch.from_numpy(noise))
        _close(out, ref)


@pytest.mark.parametrize("pred", PREDS)
@pytest.mark.parametrize("per_row", [False, True])
def test_lms_steps_match_jax_through_warmup_and_after(per_row, pred):
    """Seven chained steps (the 4-deep history fills at step 3) with the
    state carried on both sides; per-row rows start one step apart."""
    n = 10
    jsamp, tsamp = _pair("lms", n, pred)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 4, 4, 4)).astype(np.float32) * tsamp.init_noise_sigma
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jst, tst = jsamp.init_state(jx), tsamp.init_state(tx)
    assert tst["derivs"].shape == (4, 3, 4, 4, 4)
    for i in range(7):
        eps = rng.standard_normal(x.shape).astype(np.float32)
        idx = np.array([i, i + 1, i + 2]) if per_row else i
        jx, jst = jsamp.step(jnp.asarray(idx), jnp.asarray(eps), jx, jst)
        tx, tst = tsamp.step(torch.as_tensor(idx), torch.from_numpy(eps), tx, tst)
        _close(tx, jx)
        _close(tst["derivs"], jst["derivs"])


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_scale_model_input_matches_jax(kind, per_row):
    jsamp, tsamp = _pair(kind, 25)
    x = _inputs((3, 4, 4, 4), 2)[0]
    idx = np.array([0, 7, 24]) if per_row else 7
    ref = jsamp.scale_model_input(jnp.asarray(x), jnp.asarray(idx))
    out = tsamp.scale_model_input(torch.from_numpy(x), torch.as_tensor(idx))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_bf16_step_rounds_like_jax():
    """In bf16 the coefficients are cast to the latents' dtype first, as the
    JAX `_bcast` does; one bf16 ulp at the largest value."""
    jsamp, tsamp = _pair("euler_a", 10)
    x, eps, noise = _inputs((2, 4, 4, 4), 3)
    ref, _ = jsamp.step(3, jnp.asarray(eps, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16), {},
                        noise=jnp.asarray(noise))
    out, _ = tsamp.step(3, torch.from_numpy(eps).bfloat16(), torch.from_numpy(x).bfloat16(), {},
                        noise=torch.from_numpy(noise))
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                               atol=2.0 ** -7 * float(np.abs(ref).max()))


def test_bf16_ddpm_last_step_is_finite_where_the_jax_step_is_not():
    """The port forms DDPM's coefficients in f32 before casting them; the
    JAX step casts alpha_prod to bf16 first, where acp at timestep 0 rounds
    to 1 and its last step divides 0 by 0. The port's last step is its x0,
    which with acp rounded to 1 (as in the JAX and the DDIM step) is x, to
    a bf16 ulp. One step earlier, where no rounding reaches 1, the two agree
    within a bf16 ulp."""
    jsamp, tsamp = _pair("ddpm", 10)
    x, eps, noise = (a * 0.5 for a in _inputs((1, 4, 4, 4), 11))
    args = (jnp.asarray(eps, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16), {})
    targs = (torch.from_numpy(eps).bfloat16(), torch.from_numpy(x).bfloat16(), {})
    ref, _ = jsamp.step(9, *args, noise=jnp.asarray(noise))
    out, _ = tsamp.step(9, *targs, noise=torch.from_numpy(noise))
    assert np.isnan(np.asarray(ref.astype(jnp.float32))).all()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, targs[1], rtol=2.0 ** -8, atol=0)
    ref, _ = jsamp.step(8, *args, noise=jnp.asarray(noise))
    out, _ = tsamp.step(8, *targs, noise=torch.from_numpy(noise))
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                               atol=2.0 ** -7 * float(np.abs(ref).max()))


@pytest.mark.parametrize("kind", ["ddpm", "euler_a"])
def test_ancestral_noise_from_a_generator_or_given(kind):
    tsamp = make_sampler(make_schedule(), kind, 10)
    x, eps, _ = _inputs((2, 4, 4, 4), 4)
    x, eps = torch.from_numpy(x), torch.from_numpy(eps)
    drawn, _ = tsamp.step(2, eps, x, {}, generator=torch.Generator().manual_seed(5))
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(5))
    given, _ = tsamp.step(2, eps, x, {}, noise=noise)
    torch.testing.assert_close(drawn, given, rtol=0, atol=0)
    other, _ = tsamp.step(2, eps, x, {}, generator=torch.Generator().manual_seed(6))
    assert not torch.equal(drawn, other)
    with pytest.raises(ValueError, match="generator or noise"):
        tsamp.step(2, eps, x, {})


@pytest.mark.parametrize("pred", PREDS)
def test_velocity_and_to_eps_x0_match_jax(pred):
    jsch, tsch = jmake_schedule(prediction_type=pred), make_schedule(prediction_type=pred)
    x0, noise, out = _inputs((2, 4, 4, 4), 5)
    t = np.array([100, 700])
    _close(tsch.add_noise(torch.from_numpy(x0), torch.from_numpy(noise), torch.as_tensor(t)),
           jsch.add_noise(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t)))
    _close(tsch.velocity(torch.from_numpy(x0), torch.from_numpy(noise), torch.as_tensor(t)),
           jsch.velocity(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t)))
    for o, r in zip(tsch.to_eps_x0(torch.from_numpy(out), torch.as_tensor(t),
                                   torch.from_numpy(x0)),
                    jsch.to_eps_x0(jnp.asarray(out), jnp.asarray(t), jnp.asarray(x0))):
        _close(o, r)
    # the v-prediction round trip of tests/test_schedulers.py
    if pred == "v_prediction":
        x_t = tsch.add_noise(torch.from_numpy(x0), torch.from_numpy(noise), torch.as_tensor(t))
        v = tsch.velocity(torch.from_numpy(x0), torch.from_numpy(noise), torch.as_tensor(t))
        eps_rec, x0_rec = tsch.to_eps_x0(v, torch.as_tensor(t), x_t)
        np.testing.assert_allclose(eps_rec.numpy(), noise, atol=1e-5)
        np.testing.assert_allclose(x0_rec.numpy(), x0, atol=1e-5)


@pytest.mark.parametrize("per_row", [False, True])
def test_sigma_add_noise_matches_jax(per_row):
    jsamp, tsamp = _pair("euler_a", 25)
    x0, noise, _ = _inputs((3, 4, 4, 4), 6)
    idx = np.array([0, 5, 24]) if per_row else 5
    _close(ts.sigma_add_noise(tsamp, torch.from_numpy(x0), torch.from_numpy(noise),
                              torch.as_tensor(idx)),
           js.sigma_add_noise(jsamp, jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(idx)))


@pytest.mark.parametrize("pred", PREDS)
def test_ddim_inverse_step_matches_jax_and_round_trips(pred):
    jsamp, tsamp = _pair("ddim", 10, pred)
    x, eps, _ = _inputs((2, 4, 4, 4), 7)
    for i in (0, 4, 9):
        _close(tsamp.ddim_inverse_step(i, torch.from_numpy(eps), torch.from_numpy(x)),
               jsamp.ddim_inverse_step(i, jnp.asarray(eps), jnp.asarray(x)))
    # inverting i = n-1 .. 0 with a fixed eps, then sampling back, returns x
    # (epsilon prediction: the DDIM step is the exact inverse)
    if pred == "epsilon":
        tx, teps = torch.from_numpy(x).double(), torch.from_numpy(eps).double()
        z = tx
        for i in reversed(range(10)):
            z = tsamp.ddim_inverse_step(i, teps, z)
        for i in range(10):
            z, _ = tsamp.step(i, teps, z, {})
        np.testing.assert_allclose(z.numpy(), x, atol=1e-5)


# -- the goldens of tests/test_schedulers.py, on the port ------------------


def test_ddpm_final_step_recovers_x0_and_adds_no_noise():
    """At timestep 0, alpha_prev is 1, so the mean is x0 and no noise is
    added; the test is timesteps[i] <= 0, at any step count."""
    sch = make_schedule()
    for n in (50, 7):
        s = make_sampler(sch, "ddpm", n)
        assert float(s.timesteps[-1]) == 0.0
        x0, eps, noise = (torch.from_numpy(a) for a in _inputs((1, 4, 4, 4), 8))
        x_t = sch.add_noise(x0, eps, torch.tensor([0]))
        out, _ = s.step(n - 1, eps, x_t, {}, noise=noise * 100)
        np.testing.assert_allclose(out.numpy(), x0.numpy(), atol=1e-4)
        mid, _ = s.step(n - 2, eps, x_t, {}, noise=noise * 100)
        assert not np.allclose(mid.numpy(), x0.numpy(), atol=1e-2)


def test_lms_coefficients_partition_of_unity_and_first_step_is_euler():
    s = make_sampler(make_schedule(), "lms", 20)
    sig = s.sigmas.double().numpy()
    coeffs = s.lms_coeffs.double().numpy()
    for i in range(20):
        assert coeffs[i].sum() == pytest.approx(sig[i + 1] - sig[i], rel=1e-4)
    assert coeffs[0, 0] == pytest.approx(sig[1] - sig[0], rel=1e-5)
    assert np.all(coeffs[0, 1:] == 0) and np.all(coeffs[1, 2:] == 0)
    x, eps, _ = (torch.from_numpy(a) for a in _inputs((1, 4, 4, 4), 9))
    x = x * s.init_noise_sigma
    out, _ = s.step(0, eps, x, s.init_state(x))
    expected = x.numpy() + (sig[1] - sig[0]) * eps.numpy()
    np.testing.assert_allclose(out.numpy(), expected, rtol=1e-4)


def test_euler_a_sigma_split_and_x0():
    s = make_sampler(make_schedule(), "euler_a", 25)
    sig = s.sigmas.double().numpy()
    assert sig[-1] == 0.0 and s.init_noise_sigma == pytest.approx(sig.max())
    x0, eps, _ = (torch.from_numpy(a) for a in _inputs((1, 4, 4, 4), 10))
    x = ts.sigma_add_noise(s, x0, eps, 0)
    deriv, x0_rec = s._sigma_eps_x0(ts._index(0), eps, x)
    np.testing.assert_allclose(x0_rec.numpy(), x0.numpy(), atol=1e-4)
    np.testing.assert_allclose(deriv.numpy(), eps.numpy(), atol=1e-4)
    # sigma_up^2 + sigma_down^2 == sigma_to^2 at every step; the last step
    # lands on sigma 0 with no noise
    for i in range(25):
        f, t = sig[i], sig[i + 1]
        up2 = t**2 * (f**2 - t**2) / f**2
        assert up2 >= 0 and t**2 - up2 >= 0
    last, _ = s.step(24, eps, x, {}, noise=torch.full_like(x, 1e3))
    np.testing.assert_allclose(last.numpy(), (x - sig[24] * eps).numpy(), atol=1e-4)
