"""The port's CLIP vision tower and full CLIP model (models/clip_vision.py)
against sliders_tpu on the CPU: `apply_vision` and `clip_logits_per_image`
at TINY_VISION with a tiny text tower on the same weights
(`from_jax_params`), `preprocess_images` against `jax.image.resize`'s
bicubic at a shrink and a growth, and `load_clip_model` on a snapshot in
the transformers CLIPModel key layout that the port writes
(`save_clip_model`) and both packages read.

Everything runs in f32. The tower is the same operations in the same order
up to the matmuls' and the patch conv's sums: within 2e-5 of the largest
value. The resize is Keys' cubic (a = -0.5) antialiased in both
(`F.interpolate(..., antialias=True)`); its outputs agree within 1e-5 in
[0, 1] pixel units before CLIP's per-channel normalisation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers import make_tokenizer_files

from sliders_tpu.models import clip_text as jclip_text
from sliders_tpu.models import clip_vision as jcv
from sliders_tpu_torch.models import clip_text, clip_vision
from sliders_tpu_torch.models.convert import from_jax_params

REL = 2e-5


def _close(out, ref, rel=REL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=rel * float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def tiny():
    jp = jax.tree.map(np.asarray, jcv.init_params(jax.random.key(0), jcv.TINY_VISION,
                                                  jclip_text.TINY))
    rng = np.random.default_rng(1)
    pixels = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
    ids = rng.integers(0, 98, size=(2, 16)).astype(np.int32)
    ids[0, 6] = ids[1, 11] = jclip_text.TINY.eos_token_id
    return jp, from_jax_params(jp), pixels, ids


def test_apply_vision_matches_jax(tiny):
    jp, tp, pixels, _ = tiny
    ref = jcv.apply_vision(jp, jnp.asarray(pixels), jcv.TINY_VISION)
    out = clip_vision.apply_vision(tp, torch.from_numpy(pixels), clip_vision.TINY_VISION)
    for k in ("last_hidden_state", "pooler_output"):
        assert out[k].shape == ref[k].shape and out[k].dtype == torch.float32
        _close(out[k], ref[k])


def test_logits_per_image_matches_jax(tiny):
    jp, tp, pixels, ids = tiny
    ref = jcv.clip_logits_per_image(jp, jnp.asarray(pixels), jnp.asarray(ids),
                                    jcv.TINY_VISION, jclip_text.TINY)
    out = clip_vision.clip_logits_per_image(tp, torch.from_numpy(pixels),
                                            torch.from_numpy(ids).long(),
                                            clip_vision.TINY_VISION, clip_text.TINY)
    assert out.shape == (3, 2)
    _close(out, ref)


@pytest.mark.parametrize("hw,size", [((64, 64), 224), ((40, 72), 32), ((300, 200), 224),
                                     ((512, 384), 224)])
def test_preprocess_images_matches_jax_resize(hw, size):
    """A growth (64 x 64 -> 224) and shrinks (40 x 72 -> 32; 300 x 200 and
    512 x 384 -> 224): shortest side to `size`, centre crop, normalise."""
    images = np.random.default_rng(sum(hw)).integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    ref = np.asarray(jcv.preprocess_images(jnp.asarray(images), size))
    out = clip_vision.preprocess_images(torch.from_numpy(images), size).numpy()
    assert out.shape == ref.shape == (2, size, size, 3)
    std = np.asarray(clip_vision.CLIP_IMAGE_STD, np.float32)
    assert float(np.abs((out - ref) * std).max()) <= 1e-5


def test_load_clip_model_matches_jax(tmp_path):
    """A CLIPModel snapshot (config.json, model.safetensors with the
    position_ids buffers, the tokenizer files at the top level) written by
    the port: both packages load it to the same configs, token ids and
    logits."""
    vocab = make_tokenizer_files(str(tmp_path))
    tcfg = clip_text.ClipTextConfig(vocab_size=len(vocab), hidden_size=24, num_layers=2,
                                    num_heads=2, intermediate_size=48, max_positions=16,
                                    eos_token_id=vocab["<|endoftext|>"])
    vcfg = clip_vision.TINY_VISION
    params = clip_vision.init_params(torch.Generator().manual_seed(3), vcfg, tcfg,
                                     projection_dim=16)
    clip_vision.save_clip_model(str(tmp_path), params, vcfg, tcfg)
    jparams, jvcfg, jtcfg, jtok = jcv.load_clip_model(str(tmp_path))
    tparams, tvcfg, ttcfg, ttok = clip_vision.load_clip_model(str(tmp_path))
    assert tvcfg == vcfg and ttcfg.projection_dim == 16
    assert (jvcfg.hidden_size, jvcfg.patch_size) == (vcfg.hidden_size, vcfg.patch_size)
    np.testing.assert_array_equal(ttok(["an old person"]), jtok(["an old person"]))
    ids = ttok(["an old person"])
    images = np.random.default_rng(4).integers(0, 256, (2, 24, 20, 3), dtype=np.uint8)
    ref = jcv.clip_logits_per_image(jparams, jcv.preprocess_images(jnp.asarray(images), 16),
                                    jnp.asarray(ids), jvcfg, jtcfg)
    out = clip_vision.clip_logits_per_image(
        tparams, clip_vision.preprocess_images(torch.from_numpy(images), 16),
        torch.from_numpy(ids).long(), tvcfg, ttcfg)
    _close(out, ref)
