"""Parity of the port's DDIM sampler, guidance and LoRA adapter algebra with
sliders_tpu on the CPU. Tables are f32 on both sides; the step and the
guidance are compared in f32 at 1e-6 (elementwise arithmetic, same order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_tpu.diffusion import guidance as jg
from sliders_tpu.diffusion import schedulers as js
from sliders_tpu.lora import batch as jbatch
from sliders_tpu.lora import io as jio
from sliders_tpu.lora import network as jnet
from sliders_tpu.models import unet2d as junet
from sliders_tpu_torch.diffusion import guidance as tg
from sliders_tpu_torch.diffusion import schedulers as ts
from sliders_tpu_torch.lora import batch as tbatch
from sliders_tpu_torch.lora import io as tio
from sliders_tpu_torch.lora import network as tnet
from sliders_tpu_torch.models import unet2d as tunet
from sliders_tpu_torch.models.convert import from_jax_params

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("steps", [50, 5, 30])
def test_ddim_tables_match(steps):
    jsamp = js.make_sampler(js.make_schedule(), "ddim", steps)
    tsamp = ts.make_sampler(ts.make_schedule(), "ddim", steps)
    np.testing.assert_array_equal(tsamp.timesteps.numpy(), np.asarray(jsamp.timesteps))
    np.testing.assert_array_equal(tsamp.alpha_prod.numpy(), np.asarray(jsamp.alpha_prod))
    np.testing.assert_array_equal(tsamp.alpha_prod_prev.numpy(),
                                  np.asarray(jsamp.alpha_prod_prev))
    assert tsamp.init_noise_sigma == float(jsamp.init_noise_sigma) == 1.0


@pytest.mark.parametrize("per_row", [False, True])
def test_ddim_step_matches(per_row):
    rng = np.random.default_rng(0)
    jsamp = js.make_sampler(js.make_schedule(), "ddim", 50)
    tsamp = ts.make_sampler(ts.make_schedule(), "ddim", 50)
    x = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
    eps = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
    for i in (0, 17, 49):
        idx = np.array([i, max(i - 3, 0), min(i + 2, 49)]) if per_row else i
        ref, _ = jsamp.step(jnp.asarray(idx), jnp.asarray(eps), jnp.asarray(x), {})
        out, _ = tsamp.step(torch.as_tensor(idx), torch.from_numpy(eps), torch.from_numpy(x), {})
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("per_row", [False, True])
def test_cfg_combine_and_rescale(per_row):
    rng = np.random.default_rng(1)
    eps = rng.standard_normal((6, 4, 4, 4)).astype(np.float32)
    g = np.array([7.5, 1.0, 3.0], np.float32) if per_row else 7.5
    ref = jg.cfg_combine(jnp.asarray(eps), jnp.asarray(g))
    out = tg.cfg_combine(torch.from_numpy(eps), torch.as_tensor(g))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    text = eps[3:]
    ref_r = jg.rescale_noise_cfg(ref, jnp.asarray(text), 0.7)
    out_r = tg.rescale_noise_cfg(out, torch.from_numpy(text), 0.7)
    np.testing.assert_allclose(out_r.numpy(), np.asarray(ref_r), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def sd15_trees():
    """SD15 UNet parameter trees without the memory: JAX shapes and the
    port's meta-device tree."""
    jtree = jax.eval_shape(lambda k: junet.init_params(k, junet.SD15), jax.random.key(0))
    return jtree, tunet.init_params(None, tunet.SD15, device="meta")


@pytest.mark.parametrize(
    "network_type,method",
    [("lierla", "noxattn"), ("lierla", "full"), ("lierla", "selfattn"), ("lierla", "xattn"),
     ("lierla", "xattn-strict"), ("lierla", "innoxattn"), ("c3lier", "full"),
     ("c3lier", "noxattn"), ("c3lier", "noxattn-hspace"), ("c3lier", "noxattn-hspace-last")],
)
def test_target_module_paths_sd15(sd15_trees, network_type, method):
    jtree, ttree = sd15_trees
    ref = jnet.target_module_paths(jtree, network_type, method)
    assert ref
    assert tnet.target_module_paths(ttree, network_type, method) == ref


def test_create_slider_network_sd15_modules(sd15_trees):
    jtree, ttree = sd15_trees
    ref = jax.eval_shape(
        lambda k: jnet.create_slider_network(k, jtree, rank=4, alpha=1.0, train_method="noxattn"),
        jax.random.key(0))
    out = tnet.create_slider_network(None, ttree, rank=4, alpha=1.0, train_method="noxattn",
                                     device="meta")
    assert set(out) == set(ref) and len(out) == 64  # q/k/v/out of the 16 attn1 blocks
    for name, e in ref.items():  # (in, r) -> (r, in), (r, out) -> (out, r)
        assert tuple(out[name]["down"].shape) == e["down"].shape[::-1]
        assert tuple(out[name]["up"].shape) == e["up"].shape[::-1]


@pytest.mark.parametrize("init_a", [1.0, 5**0.5])
def test_create_slider_network_init(init_a):
    gen = torch.Generator().manual_seed(0)
    tiny = tunet.init_params(gen, tunet.TINY)
    out = tnet.create_slider_network(gen, tiny, rank=4, alpha=0, train_method="noxattn",
                                     init_a=init_a)
    for name, e in out.items():
        d_out, d_in = _module_weight(tiny, name).shape
        assert e["down"].shape == (4, d_in) and e["up"].shape == (d_out, 4)
        assert torch.count_nonzero(e["up"]) == 0
        assert float(e["alpha"]) == 4.0  # alpha 0 -> the rank
        bound = (6.0 / ((1.0 + init_a**2) * d_in)) ** 0.5  # kaiming-uniform
        assert float(e["down"].abs().max()) <= bound
        assert float(e["down"].abs().max()) > 0.5 * bound


def _module_weight(tree, module):
    node = tree
    for part in module.split("."):
        node = node[part]
    return node["weight"]


def _jax_adapter(rng, rank, alpha):
    return {
        "a.to_q": {"down": jnp.asarray(rng.standard_normal((12, rank)), jnp.float32),
                   "up": jnp.asarray(rng.standard_normal((rank, 10)), jnp.float32),
                   "alpha": jnp.asarray(alpha, jnp.float32)},
        "b.conv1": {"down": jnp.asarray(rng.standard_normal((3, 3, 6, rank)), jnp.float32),
                    "up": jnp.asarray(rng.standard_normal((1, 1, rank, 5)), jnp.float32),
                    "alpha": jnp.asarray(alpha, jnp.float32)},
    }


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_structure_signature_and_stack_sliders_match():
    rng = np.random.default_rng(2)
    trees = [_jax_adapter(rng, r, a) for r, a in ((2, 1.0), (4, 4.0), (3, 0.5))]
    port = [from_jax_params(_np(t)) for t in trees]
    # equal signatures for every rank; the linear entry is layout-neutral
    jsigs = [jbatch.structure_signature(t) for t in trees]
    tsigs = [tbatch.structure_signature(t) for t in port]
    assert len(set(jsigs)) == len(set(tsigs)) == 1
    assert tsigs[0][0] == jsigs[0][0]
    for pow2 in (False, True):
        ref = from_jax_params(_np(jbatch.stack_sliders(trees, round_ranks_pow2=pow2)))
        out = tbatch.stack_sliders(port, round_ranks_pow2=pow2)
        assert tbatch.is_stacked(out) and not tbatch.is_stacked(port[0])
        for name in ref:
            for k in ("down", "up", "alpha", "rank"):
                np.testing.assert_array_equal(out[name][k].numpy(), ref[name][k].numpy())
    other = from_jax_params(_np(_jax_adapter(rng, 2, 1.0)))
    other["a.to_q"]["up"] = other["a.to_q"]["up"][:7]  # another base width
    with pytest.raises(ValueError, match="different structures"):
        tbatch.stack_sliders([port[0], other])


@pytest.mark.parametrize("ext", [".safetensors", ".pt"])
def test_load_slider_reads_reference_checkpoints(tmp_path, ext):
    """A slider saved by the JAX package in the reference key format loads
    into the port with the same values (torch layouts)."""
    jparams = junet.init_params(jax.random.key(0), junet.TINY)
    w = jnet.create_slider_network(jax.random.key(1), jparams, rank=2, alpha=2.0,
                                   network_type="c3lier", train_method="full")
    rng = np.random.default_rng(3)
    w = {k: {**v, "up": jnp.asarray(rng.standard_normal(v["up"].shape), jnp.float32)}
         for k, v in w.items()}
    path = str(tmp_path / f"slider{ext}")
    jio.save_slider(path, w)
    out = tio.load_slider(path, from_jax_params(_np(jparams)))
    ref = from_jax_params(_np(w))
    assert set(out) == set(ref)
    for name in ref:
        for k in ("down", "up", "alpha"):
            np.testing.assert_allclose(out[name][k].numpy(), ref[name][k].numpy(), **TOL)
