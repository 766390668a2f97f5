"""The port's offline slider sampling against sliders_tpu on the CPU:
`make_sampling_fn` on the TINY UNets with shared weights (`from_jax_params`)
on the per-row and the scalar merged-delta paths, without CFG (SDXL-Turbo:
euler_a, guidance 1) and under lms, euler_a and ddpm with JAX's ancestral
draws; the FLUX scalar path on flux.TINY; and `compose_sliders`. The
serving engine's side (the compose route, the sampler kinds, the ancestral
samplers' no-coalescing rule) is in tests/test_torch_serving_samplers.py.

Everything runs in f32. The port and the JAX package run the same
operations in the same order except the matmuls' and convolutions' sums, so
latents agree within 1e-5 of their largest value. The merged path differs
from the branch by rounding W + delta once instead of adding the branch's
output: 1e-5 of the largest value in f32 too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_tpu.diffusion import make_sampler as jmake_sampler
from sliders_tpu.diffusion import make_schedule as jmake_schedule
from sliders_tpu.diffusion.schedulers import make_flowmatch_sampler as jflowmatch
from sliders_tpu.lora import compose as jcompose
from sliders_tpu.lora import merge as jmerge
from sliders_tpu.lora import network as jnet
from sliders_tpu.models import flux as jflux
from sliders_tpu.models import unet2d as junet
from sliders_tpu.pipelines import flux_t2i as jflux_t2i
from sliders_tpu.pipelines import text2image as jt2i
from sliders_tpu_torch.diffusion import make_sampler, make_schedule
from sliders_tpu_torch.diffusion.schedulers import make_flowmatch_sampler
from sliders_tpu_torch.lora import compose as tcompose
from sliders_tpu_torch.lora import merge as tmerge
from sliders_tpu_torch.models import flux as tflux
from sliders_tpu_torch.models import unet2d as tunet
from sliders_tpu_torch.models.convert import from_jax_params
from sliders_tpu_torch.pipelines import flux_t2i as tflux_t2i
from sliders_tpu_torch.pipelines import text2image as tt2i

REL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(out, ref, rel=REL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                               atol=rel * float(np.abs(ref).max()))


def _slider(params, key, rank=2, method="noxattn", net="lierla"):
    """A JAX slider with a nonzero up, so its scale changes the output."""
    w = jnet.create_slider_network(jax.random.key(key), params, rank=rank, alpha=1.0,
                                   train_method=method, network_type=net)
    ks = iter(jax.random.split(jax.random.key(key + 100), len(w)))
    return {m: {**e, "up": jax.random.normal(next(ks), e["up"].shape) * 0.3}
            for m, e in w.items()}


@pytest.fixture(scope="module")
def sd():
    params = junet.init_params(jax.random.key(0), junet.TINY)
    w = _slider(params, 1)
    rng = np.random.default_rng(2)
    cond, uncond = (rng.standard_normal((1, 7, 32)).astype(np.float32) for _ in range(2))
    return params, w, from_jax_params(_np(params)), from_jax_params(_np(w)), cond, uncond


def _draws(key, n, shape):
    """JAX's per-step ancestral draws: normal(fold_in(key, i), x.shape)."""
    return [np.asarray(jax.random.normal(jax.random.fold_in(key, i), shape, jnp.float32))
            for i in range(n)]


def _latents(seed, shape, sigma):
    return (np.random.default_rng(seed).standard_normal(shape) * sigma).astype(np.float32)


@pytest.mark.parametrize("kind", ["ddim", "lms", "euler_a"])
def test_scalar_merged_path_matches_jax_and_the_per_row_path(sd, kind):
    """A 0-d scale with one adapter: the port's merged path against the JAX
    merged path (its draws injected), and against the port's own per-row
    branch at a (B,) vector of that scale on the same latents and draws.
    start_noise 600 leaves the slider off for the first steps."""
    params, w, tparams, tw, cond, uncond = sd
    n, B = 5, 2
    jsamp, tsamp = jmake_sampler(jmake_schedule(), kind, n), make_sampler(make_schedule(), kind, n)
    lat = _latents(3, (B, 8, 8, 4), tsamp.init_noise_sigma)
    noise = _draws(jax.random.key(4), n, lat.shape)
    jfn = jt2i.make_sampling_fn(junet.TINY, jsamp, compute_dtype=jnp.float32)
    ref = jfn(params, jnp.asarray(lat), jnp.tile(cond, (B, 1, 1)), jnp.tile(uncond, (B, 1, 1)),
              w, jnp.asarray(1.5), jnp.asarray(600.0), jnp.asarray(7.5), jax.random.key(4))
    tfn = tt2i.make_sampling_fn(tunet.TINY, tsamp, compute_dtype=torch.float32)
    args = (tparams, torch.from_numpy(lat), torch.from_numpy(cond).expand(B, -1, -1),
            torch.from_numpy(uncond).expand(B, -1, -1), tw)
    step_noise = [torch.from_numpy(a) for a in noise] if tsamp.stochastic else None
    merged = tfn(*args, 1.5, 600.0, 7.5, step_noise=step_noise)
    branch = tfn(*args, torch.full((B,), 1.5), 600.0, 7.5, step_noise=step_noise)
    _close(merged, ref)
    _close(merged, branch)
    base = tfn(*args, torch.zeros(B), 600.0, 7.5, step_noise=step_noise)
    assert not torch.allclose(merged, base, atol=1e-3)  # the slider acts
    with pytest.raises(ValueError, match="scalar start_noise"):
        tfn(*args, 1.5, torch.full((B,), 600.0), 7.5, step_noise=step_noise)


@pytest.mark.parametrize("kind", ["lms", "euler_a", "ddpm"])
def test_per_row_samplers_match_jax_with_its_draws(sd, kind):
    """Per-row scales, gates and guidance under each non-DDIM sampler; the
    ancestral draws are JAX's fold_in(key, i) normals."""
    params, w, tparams, tw, cond, uncond = sd
    n, B = 6, 3
    jsamp, tsamp = jmake_sampler(jmake_schedule(), kind, n), make_sampler(make_schedule(), kind, n)
    lat = _latents(5, (B, 8, 8, 4), tsamp.init_noise_sigma)
    scales = np.array([-1.0, 0.0, 2.0], np.float32)
    sn = np.array([1000.0, 500.0, 300.0], np.float32)
    g = np.array([7.5, 3.0, 1.5], np.float32)
    jfn = jt2i.make_sampling_fn(junet.TINY, jsamp, compute_dtype=jnp.float32)
    ref = jfn(params, jnp.asarray(lat), jnp.tile(cond, (B, 1, 1)), jnp.tile(uncond, (B, 1, 1)),
              w, jnp.asarray(scales), jnp.asarray(sn), jnp.asarray(g), jax.random.key(6))
    tfn = tt2i.make_sampling_fn(tunet.TINY, tsamp, compute_dtype=torch.float32)
    out = tfn(tparams, torch.from_numpy(lat), torch.from_numpy(cond).expand(B, -1, -1),
              torch.from_numpy(uncond).expand(B, -1, -1), tw, torch.from_numpy(scales),
              torch.from_numpy(sn), torch.from_numpy(g),
              step_noise=[torch.from_numpy(a) for a in _draws(jax.random.key(6), n, lat.shape)])
    _close(out, ref)
    if tsamp.stochastic:
        with pytest.raises(ValueError, match="generator or step_noise"):
            tfn(tparams, torch.from_numpy(lat), torch.from_numpy(cond).expand(B, -1, -1),
                torch.from_numpy(uncond).expand(B, -1, -1), tw, torch.from_numpy(scales),
                torch.from_numpy(sn), torch.from_numpy(g))


def test_generator_draws_one_noise_per_step_for_the_batch(sd):
    """With a generator the step noise is one (B, h, w, c) draw per step, in
    step order: step_noise drawn from the same generator gives the same
    latents."""
    _, _, tparams, tw, cond, uncond = sd
    n, B = 3, 2
    tsamp = make_sampler(make_schedule(), "euler_a", n)
    lat = torch.from_numpy(_latents(7, (B, 8, 8, 4), tsamp.init_noise_sigma))
    tfn = tt2i.make_sampling_fn(tunet.TINY, tsamp, compute_dtype=torch.float32)
    args = (tparams, lat, torch.from_numpy(cond).expand(B, -1, -1),
            torch.from_numpy(uncond).expand(B, -1, -1), tw, torch.ones(B), 1000.0, 7.5)
    drawn = tfn(*args, generator=torch.Generator().manual_seed(9))
    g = torch.Generator().manual_seed(9)
    given = tfn(*args, step_noise=[torch.randn(lat.shape, generator=g) for _ in range(n)])
    torch.testing.assert_close(drawn, given, rtol=0, atol=0)


def test_no_cfg_turbo_matches_jax():
    """SDXL-Turbo's path on TINY_XL: euler_a, 3 steps, guidance 1 (no CFG
    row doubling), start_noise 700, added conditioning without uncond keys;
    per-row scales and the scalar merged path."""
    params = junet.init_params(jax.random.key(10), junet.TINY_XL)
    w = _slider(params, 11)
    tparams, tw = from_jax_params(_np(params)), from_jax_params(_np(w))
    n, B = 3, 3
    jsamp = jmake_sampler(jmake_schedule(), "euler_a", n)
    tsamp = make_sampler(make_schedule(), "euler_a", n)
    rng = np.random.default_rng(12)
    lat = _latents(13, (B, 8, 8, 4), tsamp.init_noise_sigma)
    cond = np.repeat(rng.standard_normal((1, 7, 32)).astype(np.float32), B, axis=0)
    added = {"text_embeds": np.repeat(rng.standard_normal((1, 16)).astype(np.float32), B, 0),
             "time_ids": np.repeat(np.array([[64, 64, 0, 0, 64, 64]], np.float32), B, 0)}
    scales = np.array([-2.0, 0.0, 2.0], np.float32)
    noise = _draws(jax.random.key(14), n, lat.shape)
    jfn = jt2i.make_sampling_fn(junet.TINY_XL, jsamp, use_cfg=False, compute_dtype=jnp.float32,
                                is_xl=True)
    tfn = tt2i.make_sampling_fn(tunet.TINY_XL, tsamp, use_cfg=False, compute_dtype=torch.float32)
    jadded = {k: jnp.asarray(v) for k, v in added.items()}
    tadded = {k: torch.from_numpy(v) for k, v in added.items()}
    step_noise = [torch.from_numpy(a) for a in noise]
    for scale in (scales, np.float32(2.0)):
        ref = jfn(params, jnp.asarray(lat), jnp.asarray(cond), jnp.asarray(cond), w,
                  jnp.asarray(scale), jnp.asarray(700.0), jnp.asarray(1.0), jax.random.key(14),
                  jadded)
        out = tfn(tparams, torch.from_numpy(lat), torch.from_numpy(cond), None, tw,
                  torch.as_tensor(scale), 700.0, 1.0, tadded, step_noise=step_noise)
        _close(out, ref)
    assert not torch.allclose(out[0], out[1], atol=1e-3)


def test_flux_scalar_merged_path_matches_jax():
    """make_flux_sampling_fn with a 0-d scale and one adapter against the
    JAX merged path, and against the port's per-row branch at a (B,) vector;
    skip_till 0 turns the slider on from step 1."""
    cfg = jflux.TINY
    params = jflux.init_params(jax.random.key(20), cfg)
    w = _slider(params, 21, method="xattn")
    tparams, tw = from_jax_params(_np(params)), from_jax_params(_np(w))
    rng = np.random.default_rng(22)
    B, hw, n = 2, 8, 3
    lat = np.asarray(jflux.pack_latents(jnp.asarray(
        rng.standard_normal((B, hw, hw, 4)).astype(np.float32))))
    pooled = rng.standard_normal((B, 24)).astype(np.float32)
    t5e = rng.standard_normal((B, 6, 32)).astype(np.float32)
    jfn = jflux_t2i.make_flux_sampling_fn(cfg, jflowmatch(n, image_seq_len=16), latent_hw=hw,
                                          compute_dtype=jnp.float32)
    ref = jfn(params, jnp.asarray(lat), jnp.asarray(pooled), jnp.asarray(t5e), w,
              jnp.asarray(1.5), jnp.asarray(0.0), jnp.asarray(3.5))
    tfn = tflux_t2i.make_flux_sampling_fn(tflux.TINY, make_flowmatch_sampler(n, image_seq_len=16),
                                          latent_hw=hw, compute_dtype=torch.float32)
    args = (tparams, torch.from_numpy(lat), torch.from_numpy(pooled), torch.from_numpy(t5e), tw)
    merged = tfn(*args, 1.5, 0.0, 3.5)
    branch = tfn(*args, torch.full((B,), 1.5), torch.zeros(B), 3.5)
    _close(merged, ref)
    _close(merged, branch)
    with pytest.raises(ValueError, match="scalar skip_till"):
        tfn(*args, 1.5, torch.zeros(B), 3.5)


def test_compose_sliders_matches_jax():
    """Two adapters of different ranks and module sets (one with conv
    entries), composed at scales 1.5 and -0.75: the tree equals the JAX
    composition's, alpha is the total rank, and the merged delta of the
    composition equals the sum of the scaled deltas."""
    params = junet.init_params(jax.random.key(30), junet.TINY)
    a = _slider(params, 31, rank=2, method="noxattn", net="c3lier")
    b = _slider(params, 32, rank=3, method="xattn")
    ta, tb = from_jax_params(_np(a)), from_jax_params(_np(b))
    assert any(e["down"].ndim == 4 for e in ta.values())  # conv entries
    assert set(ta) != set(tb)
    ref = from_jax_params(_np(jcompose.compose_sliders([(a, 1.5), (b, -0.75)])))
    out = tcompose.compose_sliders([(ta, 1.5), (tb, -0.75)])
    assert set(out) == set(ref) == set(ta) | set(tb)
    for m in ref:
        for k in ("down", "up"):
            assert out[m][k].shape == ref[m][k].shape
            np.testing.assert_allclose(out[m][k].numpy(), ref[m][k].numpy(), rtol=1e-6, atol=0)
        both = m in ta and m in tb
        assert float(out[m]["alpha"]) == (5.0 if both else 2.0 if m in ta else 3.0)
    deltas = tmerge.lora_deltas(out, 1.0)
    da, db = tmerge.lora_deltas(ta, 1.5), tmerge.lora_deltas(tb, -0.75)
    jd = jmerge.lora_deltas(jcompose.compose_sliders([(a, 1.5), (b, -0.75)]), 1.0)
    for m, d in deltas.items():
        want = da.get(m, 0) + db.get(m, 0)
        scale = float(np.abs(want.numpy()).max())
        np.testing.assert_allclose(d.numpy(), want.numpy(), rtol=0, atol=1e-6 * scale)
        j = np.asarray(jd[m])
        j = j.T if j.ndim == 2 else j.transpose(3, 2, 0, 1)  # JAX (in, out) / HWIO
        np.testing.assert_allclose(d.numpy(), j, rtol=0, atol=1e-6 * scale)
    with pytest.raises(ValueError):
        tcompose.compose_sliders([])
