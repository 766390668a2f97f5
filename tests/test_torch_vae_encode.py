"""The port's VAE encode against the JAX package's on the CPU: `encode`
(with the downsample's asymmetric (0, 1, 0, 1) pad and stride-2 conv, and
logvar clipped to [-30, 20]), `sample_latents` on a given eps and
`normalize_latents`, on the same weights (JAX init carried over by
`from_jax_params`) and the same seeded numpy images, in f32. Tolerances are
relative to the output's scale (only f32 summation orders differ). Also the
encoder's routing: under conv impl 'auto' its stride-1 3x3 convs take kernel
#5 and its stride-2 and 1x1 convs stay on cuDNN, and its mid attention at
the SD and SDXL training resolutions is kernel #4's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_tpu.models import vae as jvae
from sliders_tpu_torch.models import vae as tvae
from sliders_tpu_torch.models.convert import from_jax_params
from sliders_tpu_torch.models.params import tree_to
from sliders_tpu_torch.ops import attention as tattn
from sliders_tpu_torch.ops import basic, conv3x3


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(out: torch.Tensor, ref, rel: float):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=rel * scale)


@pytest.fixture(scope="module")
def tiny():
    jparams = jvae.init_params(jax.random.key(3), jvae.TINY)
    return jparams, from_jax_params(_np_tree(jparams))


@pytest.mark.parametrize("hw", [(32, 32), (24, 40)])
def test_encode_matches_jax(tiny, hw):
    """mean and logvar of 2 images within 1e-5 of the output's scale, on a
    square and a non-square size (the downsample pads H and W by one at the
    end, then convolves at stride 2 with no padding)."""
    jparams, tparams = tiny
    rng = np.random.default_rng(0)
    imgs = rng.uniform(-1, 1, (2, *hw, 3)).astype(np.float32)
    jmean, jlogvar = jvae.encode(jparams, jvae.TINY, jnp.asarray(imgs))
    mean, logvar = tvae.encode(tparams, tvae.TINY, torch.from_numpy(imgs))
    assert mean.shape == logvar.shape == (2, hw[0] // 2, hw[1] // 2, 4) == jmean.shape
    _close(mean, jmean, 1e-5)
    _close(logvar, jlogvar, 1e-5)


def test_sample_and_normalize_match_jax(tiny):
    """sample_latents on a given eps, then normalize_latents (SD's scale, and
    FLUX's shift and scale), within 1e-5 of the output's scale."""
    jparams, tparams = tiny
    rng = np.random.default_rng(1)
    imgs = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    eps = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    jmean, jlogvar = jvae.encode(jparams, jvae.TINY, jnp.asarray(imgs))
    jz = jmean + jnp.exp(0.5 * jlogvar) * jnp.asarray(eps)  # jvae.sample_latents' formula
    mean, logvar = tvae.encode(tparams, tvae.TINY, torch.from_numpy(imgs))
    z = tvae.sample_latents(mean, logvar, eps=torch.from_numpy(eps))
    _close(z, jz, 1e-5)
    for jcfg, tcfg in ((jvae.TINY, tvae.TINY), (jvae.TINY_FLUX, tvae.TINY_FLUX)):
        _close(tvae.normalize_latents(tcfg, z), jvae.normalize_latents(jcfg, jz), 1e-5)


def test_sample_latents_draws_from_the_generator(tiny):
    """Without eps, the draw is unit normal from the generator: the same
    seed gives the same latents, and eps = 0 gives the mean."""
    _, tparams = tiny
    imgs = torch.zeros(1, 16, 16, 3)
    mean, logvar = tvae.encode(tparams, tvae.TINY, imgs)
    a = tvae.sample_latents(mean, logvar, torch.Generator().manual_seed(5))
    b = tvae.sample_latents(mean, logvar, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, mean)
    assert torch.equal(tvae.sample_latents(mean, logvar, eps=torch.zeros_like(mean)), mean)


@pytest.mark.parametrize("bias", [50.0, -50.0])
def test_logvar_is_clipped_like_jax(tiny, bias):
    """A quant_conv bias that pushes logvar out of range is clipped to 20 /
    -30 exactly, in both packages."""
    jparams, _ = tiny
    b = np.asarray(jparams["quant_conv"]["bias"]).copy()
    b[4:] = bias
    jparams = {**jparams, "quant_conv": {**jparams["quant_conv"], "bias": jnp.asarray(b)}}
    imgs = np.random.default_rng(2).uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    _, jlogvar = jvae.encode(jparams, jvae.TINY, jnp.asarray(imgs))
    _, logvar = tvae.encode(from_jax_params(_np_tree(jparams)), tvae.TINY, torch.from_numpy(imgs))
    expected = 20.0 if bias > 0 else -30.0
    assert bool((logvar == expected).all()) and bool((np.asarray(jlogvar) == expected).all())


def test_encode_in_f32_from_bf16_weights(tiny):
    """Weights loaded in bf16 encode f32 images in f32 (every conv casts its
    weights to the activation's dtype): the result is the f32 encode of the
    bf16-rounded weights."""
    _, tparams = tiny
    bf16 = tree_to(tparams, "cpu", torch.bfloat16)
    rounded = tree_to(bf16, "cpu", torch.float32)
    imgs = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (1, 16, 16, 3))
                            .astype(np.float32))
    mean, logvar = tvae.encode(bf16, tvae.TINY, imgs)
    rmean, rlogvar = tvae.encode(rounded, tvae.TINY, imgs)
    assert mean.dtype == torch.float32
    assert torch.equal(mean, rmean) and torch.equal(logvar, rlogvar)


def test_auto_routes_the_stride1_convs_only(monkeypatch):
    """Under conv impl 'auto', every stride-1 3x3 conv of an encoder that
    passes kernel #5's gate goes to #5 (its plain version here) and no
    stride-2 or 1x1 conv does; the result equals the 'xla' route's within
    1e-5 of its scale."""
    cfg = tvae.VaeConfig(block_out_channels=(128, 128), layers_per_block=1, norm_num_groups=32)
    params = tvae.init_params(torch.Generator().manual_seed(0), cfg)
    imgs = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, (1, 32, 32, 3))
                            .astype(np.float32))
    seen = []
    plain = conv3x3.conv3x3

    def record(x, w, b):
        seen.append((tuple(x.shape), tuple(w.shape)))
        return plain(x, w, b)

    monkeypatch.setattr(conv3x3, "conv3x3", record)
    ref = tvae.encode(params, cfg, imgs)
    assert not seen
    basic.set_conv_impl("auto")
    try:
        out = tvae.encode(params, cfg, imgs)
    finally:
        basic.set_conv_impl("xla")
    # block 0 at 32x32: resnet conv1, conv2; block 1 at 16x16: resnet conv1,
    # conv2; the mid block's two resnets: 4; conv_in (C = 3) and conv_out
    # (N = 8) fail the gate, the downsample is stride 2
    assert seen == [((1, 32, 32, 128), (128, 128, 3, 3))] * 2 + \
        [((1, 16, 16, 128), (128, 128, 3, 3))] * 6
    for a, b in zip(out, ref):
        _close(a, b.numpy(), 1e-5)


@pytest.mark.parametrize("px", [256, 512])
def test_mid_attention_routes_to_flash_at_training_sizes(px):
    """The encoder's mid attention on the 2 images of a pair, (2, 1, (px /
    8)^2, 512) in f32, is kernel #4's (the JAX gate's decision)."""
    shape = (2, 1, (px // 8) ** 2, 512)
    assert tattn.routes_to_flash_kernel(shape, shape, None, itemsize=4)
