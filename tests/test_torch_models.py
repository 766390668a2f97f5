"""Parity of the port's UNet, CLIP text encoder and VAE decoder with the JAX
modules on the CPU, on the same weights (JAX init carried over by
`from_jax_params`) and the same seeded numpy inputs, in f32. Tolerances are
relative to the output's scale: only summation orders differ, compounded
through the network's depth.

The full-size configurations (SD15, CLIP_L, SD_VAE) are checked for
structure only: parameter names, shapes (in torch layouts) and counts,
through jax.eval_shape and the port's init on the meta device.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_tpu.lora.network import create_slider_network as jax_slider_network
from sliders_tpu.models import clip_text as jclip
from sliders_tpu.models import unet2d as junet
from sliders_tpu.models import vae as jvae
from sliders_tpu.ops.basic import SliderLora as JaxSliderLora
from sliders_tpu.utils import pytree as jpytree
from sliders_tpu_torch.models import clip_text as tclip
from sliders_tpu_torch.models import unet2d as tunet
from sliders_tpu_torch.models import vae as tvae
from sliders_tpu_torch.models.convert import from_jax_params
from sliders_tpu_torch.ops.basic import SliderLora
from sliders_tpu_torch.utils import pytree as tpytree


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(out: torch.Tensor, ref, rel: float):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=rel * scale)


def test_unet_tiny_with_vector_scale_slider():
    rng = np.random.default_rng(0)
    jparams = junet.init_params(jax.random.key(0), junet.TINY)
    slider = jax_slider_network(jax.random.key(1), jparams, rank=4, train_method="noxattn")
    slider = {k: {**v, "up": jnp.asarray(rng.standard_normal(v["up"].shape) * 0.1, jnp.float32)}
              for k, v in slider.items()}
    x = rng.standard_normal((3, 8, 8, 4)).astype(np.float32)
    t = np.array([999.0, 500.0, 1.0], np.float32)
    ctx = rng.standard_normal((3, 7, 32)).astype(np.float32)
    mult = np.array([-1.0, 0.0, 2.0], np.float32)
    ref = junet.apply(jparams, junet.TINY, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                      lora=JaxSliderLora(weights=slider, multiplier=jnp.asarray(mult)))
    out = tunet.apply(from_jax_params(_np_tree(jparams)), tunet.TINY, torch.from_numpy(x),
                      torch.from_numpy(t), torch.from_numpy(ctx),
                      lora=SliderLora(weights=from_jax_params(_np_tree(slider)),
                                      multiplier=torch.from_numpy(mult)))
    assert out.shape == ref.shape
    _close(out, ref, 1e-5)


def test_clip_tiny():
    rng = np.random.default_rng(1)
    cfg_j, cfg_t = jclip.TINY, tclip.TINY
    jparams = jclip.init_params(jax.random.key(2), cfg_j)
    ids = rng.integers(0, cfg_j.vocab_size - 1, size=(2, cfg_j.max_positions)).astype(np.int32)
    ids[0, 5:] = cfg_j.eos_token_id
    ids[1, 9:] = cfg_j.eos_token_id
    ref = jclip.apply(jparams, jnp.asarray(ids), cfg_j)
    out = tclip.apply(from_jax_params(_np_tree(jparams)), torch.from_numpy(ids).long(), cfg_t)
    for key in ("last_hidden_state", "pooler_output", "text_embeds"):
        _close(out[key], ref[key], 1e-5)
    # clip_skip truncation
    ref1 = jclip.apply(jparams, jnp.asarray(ids), cfg_j, num_layers=1)["last_hidden_state"]
    out1 = tclip.apply(from_jax_params(_np_tree(jparams)), torch.from_numpy(ids).long(), cfg_t,
                       num_layers=1)["last_hidden_state"]
    _close(out1, ref1, 1e-5)


def test_vae_tiny_decode():
    rng = np.random.default_rng(2)
    jparams = jvae.init_params(jax.random.key(3), jvae.TINY)
    z = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ref = jvae.decode(jparams, jvae.TINY, jnp.asarray(z))
    out = tvae.decode(from_jax_params(_np_tree(jparams)), tvae.TINY, torch.from_numpy(z))
    assert out.shape == ref.shape == (2, 16, 16, 3)
    _close(out, ref, 1e-5)


def _torch_layout_shape(path: str, shape: tuple) -> tuple:
    if path.endswith(".weight") and not path.endswith("embedding.weight"):
        if len(shape) == 2:
            return shape[::-1]
        if len(shape) == 4:
            return (shape[3], shape[2], shape[0], shape[1])
    return shape


@pytest.mark.parametrize(
    "name,jax_init,port_init,count",
    [
        ("unet_sd15", lambda k: junet.init_params(k, junet.SD15),
         lambda: tunet.init_params(None, tunet.SD15, device="meta"), 859_520_964),
        ("clip_l", lambda k: jclip.init_params(k, jclip.CLIP_L),
         lambda: tclip.init_params(None, tclip.CLIP_L, device="meta"), 123_060_480),
        ("sd_vae", lambda k: jvae.init_params(k, jvae.SD_VAE),
         lambda: tvae.init_params(None, tvae.SD_VAE, device="meta"), 83_653_863),
        # diffusers' sdxl-base-1.0 UNet (tests/test_unet.py pins the same count)
        ("unet_sdxl", lambda k: junet.init_params(k, junet.SDXL),
         lambda: tunet.init_params(None, tunet.SDXL, device="meta"), 2_567_463_684),
        ("clip_big_g", lambda k: jclip.init_params(k, jclip.CLIP_BIG_G),
         lambda: tclip.init_params(None, tclip.CLIP_BIG_G, device="meta"), 694_659_840),
        ("sdxl_vae", lambda k: jvae.init_params(k, jvae.SDXL_VAE),
         lambda: tvae.init_params(None, tvae.SDXL_VAE, device="meta"), 83_653_863),
    ],
)
def test_full_size_structure_matches(name, jax_init, port_init, count):
    jflat = jpytree.flatten(jax.eval_shape(jax_init, jax.random.key(0)))
    tflat = tpytree.flatten(port_init())
    assert set(jflat) == set(tflat)
    for path, leaf in jflat.items():
        assert tuple(tflat[path].shape) == _torch_layout_shape(path, tuple(leaf.shape)), path
    n_jax = sum(math.prod(leaf.shape) for leaf in jflat.values())
    n_port = sum(t.numel() for t in tflat.values())
    assert n_jax == n_port == count
