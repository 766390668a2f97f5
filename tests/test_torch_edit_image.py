"""`pipelines/inversion.edit_image` end to end against sliders_tpu's on the
tiny SD snapshot in f32 on the CPU. Its parts (the DDIM inversion, the
null-text optimiser, the edit sampling) are held to the JAX package's at
1e-5 of the largest value in tests/test_torch_inversion.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from helpers import make_tiny_snapshot

from sliders_tpu.lora import network as jnet
from sliders_tpu.models import loader as jloader
from sliders_tpu.pipelines import inversion as jinv
from sliders_tpu_torch.models import loader as tloader
from sliders_tpu_torch.models.convert import from_jax_params
from sliders_tpu_torch.pipelines import inversion as tinv

def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _slider(params, key):
    w = jnet.create_slider_network(jax.random.key(key), params, rank=2, train_method="noxattn")
    ks = iter(jax.random.split(jax.random.key(key + 100), len(w)))
    return {m: {**e, "up": jax.random.normal(next(ks), e["up"].shape) * 0.3}
            for m, e in w.items()}


def test_edit_image_matches_jax(tmp_path_factory):
    """`edit_image` end to end on the tiny snapshot (VAE encode, inversion,
    null-text, one batched sweep of scales (0, 2), decode) against the JAX
    package's, 32 px, 3 steps, 2 inner steps: the uint8 images equal but
    for a rounding at the final truncation (one level, on at most 0.1 % of
    the values), and distinct across the scales."""
    snap = make_tiny_snapshot(str(tmp_path_factory.mktemp("edit") / "sd_tiny"))
    jm = jloader.load_sd(snap, dtype=jnp.float32, load_vae=True)
    tm = tloader.load_sd(snap, dtype=torch.float32, load_vae=True)
    w = _slider(jm.unet_params, 9)
    image = np.random.default_rng(6).uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    kw = dict(num_steps=3, start_noise=500.0, guidance_scale=7.5, num_inner_steps=2)
    ref = jinv.edit_image(jm, jnp.asarray(image), "a person", w, (0.0, 2.0), **kw)
    timings = {}
    out = tinv.edit_image(tm, image, "a person", from_jax_params(_np(w)), (0.0, 2.0),
                          timings=timings, **kw)
    assert set(out) == set(ref) == {0.0, 2.0}
    assert set(timings) == {"encode", "inversion", "null_text", "edit", "decode"}
    for s in out:
        assert out[s].dtype == np.uint8 and out[s].shape == (32, 32, 3)
        diff = np.abs(out[s].astype(int) - np.asarray(ref[s]).astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())
    assert not np.array_equal(out[0.0], out[2.0])
    solo = tinv.edit_image(tm, image, "a person", None, (0.0, 2.0), **kw)
    assert np.array_equal(solo[0.0], solo[2.0])
