"""The port's LPIPS (evals/lpips.py) against sliders_tpu on the CPU:
`alexnet_features` and `lpips_distance` at full AlexNet width on 64 px
inputs with the same weights (`from_jax_params`) within 1e-5 relative;
`load_torch_weights` on checkpoint files in the torchvision / lpips key
layouts equal to the JAX package's tree; and `load_image_64` (the port's
PNG decoder and its copy of PIL's 8-bit bilinear resize) equal, bit for
bit, to the JAX loader (PIL) on PNGs that shrink, grow, have odd sizes or
an alpha channel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sliders_tpu.evals import lpips as jlpips
from sliders_tpu_torch.evals import lpips
from sliders_tpu_torch.models.convert import from_jax_params

REL = 1e-5


@pytest.fixture(scope="module")
def weights():
    jp = jax.tree.map(np.asarray, jlpips.init_params(jax.random.key(0)))
    return jp, from_jax_params(jp)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    return tuple(rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32) for _ in range(2))


def test_alexnet_features_match_jax(weights, inputs):
    jp, tp = weights
    ref = jlpips.alexnet_features(jp, jnp.asarray(inputs[0]))
    out = lpips.alexnet_features(tp, torch.from_numpy(inputs[0]))
    assert [o.shape[-1] for o in out] == [c for c, _, _, _ in lpips.ALEX_CONVS]
    for o, r in zip(out, ref):
        r = np.asarray(r)
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), r, rtol=0, atol=REL * float(np.abs(r).max()))


def test_lpips_distance_matches_jax(weights, inputs):
    jp, tp = weights
    x, y = inputs
    ref = np.asarray(jlpips.lpips_distance(jp, jnp.asarray(x), jnp.asarray(y)))
    out = lpips.lpips_distance(tp, torch.from_numpy(x), torch.from_numpy(y))
    assert out.shape == (2,) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=REL, atol=0)
    same = lpips.lpips_distance(tp, torch.from_numpy(x), torch.from_numpy(x))
    assert torch.equal(same, torch.zeros(2))


def test_load_torch_weights_matches_jax(tmp_path):
    """Files in the real layouts: torchvision alexnet's state dict (its
    classifier too) and the lpips package's alex.pth (lin{i}.model.1.weight
    of shape (1, C, 1, 1)); the port's tree is the JAX tree in torch
    layouts, and `torchvision_state` writes the files back unchanged."""
    gen = torch.Generator().manual_seed(2)
    params = lpips.init_params(gen)
    alex, lins = lpips.torchvision_state(params)
    alex = {**alex, "classifier.1.weight": torch.randn(8, 9216 // 1024, generator=gen),
            "classifier.1.bias": torch.zeros(8)}
    torch.save(alex, tmp_path / "alexnet.pth")
    torch.save(lins, tmp_path / "alex.pth")
    ref = from_jax_params(jax.tree.map(np.asarray, jlpips.load_torch_weights(
        str(tmp_path / "alexnet.pth"), str(tmp_path / "alex.pth"))))
    out = lpips.load_torch_weights(str(tmp_path / "alexnet.pth"), str(tmp_path / "alex.pth"))
    for group in ("convs", "lins"):
        assert set(out[group]) == set(ref[group]) == {str(i) for i in range(5)}
        for i, leaves in ref[group].items():
            for k, want in leaves.items():
                assert torch.equal(out[group][i][k], want), (group, i, k)
                assert torch.equal(out[group][i][k], params[group][i][k])
    back, back_lins = lpips.torchvision_state(out)
    assert all(torch.equal(back[k], alex[k]) for k in back)
    assert all(torch.equal(back_lins[k], lins[k]) for k in lins)


@pytest.mark.parametrize("w,h,mode", [(200, 150, "RGB"), (512, 512, "RGB"), (40, 30, "RGB"),
                                      (63, 65, "RGB"), (97, 33, "RGB"), (48, 80, "RGB"),
                                      (64, 64, "RGB"), (120, 90, "RGBA")])
def test_load_image_64_equals_jax(tmp_path, w, h, mode):
    """PNGs written by PIL that shrink, grow, keep their size, have odd
    sizes or an alpha channel: the same float32 array, bit for bit."""
    rng = np.random.default_rng(w * h)
    y, x = np.mgrid[0:h, 0:w]
    smooth = (127 + 120 * np.sin(x / 7.0)[..., None] * np.cos(y / 5.0)[..., None]
              * np.array([1.0, -0.6, 0.3]))
    img = np.clip(smooth + rng.integers(-20, 21, (h, w, 3)), 0, 255).astype(np.uint8)
    if mode == "RGBA":
        img = np.concatenate([img, rng.integers(0, 256, (h, w, 1), dtype=np.uint8)], axis=2)
    path = str(tmp_path / "img.png")
    Image.fromarray(img, mode).save(path)
    ref = np.asarray(jlpips.load_image_64(path))
    out = lpips.load_image_64(path)
    assert out.dtype == torch.float32 and min(out.shape[1:3]) == 64
    np.testing.assert_array_equal(out.numpy(), ref)
