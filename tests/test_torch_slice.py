"""The port's serving slice end to end on the CPU, against the JAX package.

A tiny diffusers snapshot (tests/helpers.make_tiny_snapshot) is loaded by
both loaders; the same injected numpy latents go through 5 DDIM steps at
64 px with a slider at scales [-1, 0, 1] and start_noise 750, then the VAE.
The uint8 images may differ by one level (f32 sums in another order can flip
a rounding at the final truncation).
"""

import base64
import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers import make_tiny_snapshot

from sliders_tpu.diffusion import schedulers as js
from sliders_tpu.lora import network as jnet
from sliders_tpu.models import loader as jloader
from sliders_tpu.pipelines import text2image as jt2i
from sliders_tpu_torch.cli import serve as tserve
from sliders_tpu_torch.diffusion import schedulers as ts
from sliders_tpu_torch.models import loader as tloader
from sliders_tpu_torch.models.convert import from_jax_params, read_safetensors
from sliders_tpu_torch.pipelines import text2image as tt2i
from sliders_tpu_torch.serving.server import SliderEngine, encode_png, make_http_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    return make_tiny_snapshot(str(tmp_path_factory.mktemp("sd_tiny")))


def _jax_slider(params, seed=1):
    w = jnet.create_slider_network(jax.random.key(seed), params, rank=4, train_method="noxattn")
    rng = np.random.default_rng(seed)
    return {k: {**v, "up": jnp.asarray(rng.standard_normal(v["up"].shape) * 0.1, jnp.float32)}
            for k, v in w.items()}


def test_slice_matches_jax(snapshot):
    jm = jloader.load_sd(snapshot, dtype=jnp.float32, load_vae=True)
    tm = tloader.load_sd(snapshot, dtype=torch.float32, load_vae=True)
    jw = _jax_slider(jm.unet_params)
    tw = from_jax_params(jax.tree.map(np.asarray, jw))
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((3, 8, 8, 4)).astype(np.float32)
    scales = np.array([-1.0, 0.0, 1.0], np.float32)

    jc, ju, _ = jt2i.encode_conditioning(jm, "a photo of an old person", "", 64)
    tc, tu = tt2i.encode_conditioning(tm, "a photo of an old person", "")
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)

    jfn = jt2i.make_sampling_fn(jm.unet_config, js.make_sampler(js.make_schedule(), "ddim", 5),
                                compute_dtype=jnp.float32)
    jx = jfn(jm.unet_params, jnp.asarray(lat), jnp.tile(jc, (3, 1, 1)), jnp.tile(ju, (3, 1, 1)),
             jw, jnp.asarray(scales), jnp.full((3,), 750.0), jnp.full((3,), 7.5),
             jax.random.key(0))
    tfn = tt2i.make_sampling_fn(tm.unet_config, ts.make_sampler(ts.make_schedule(), "ddim", 5),
                                compute_dtype=torch.float32)
    tx = tfn(tm.unet_params, torch.from_numpy(lat), *tt2i.tile_conditioning(tc, tu, 3), tw,
             torch.from_numpy(scales), torch.full((3,), 750.0), torch.full((3,), 7.5))
    jx = np.asarray(jx)
    np.testing.assert_allclose(tx.numpy(), jx, rtol=0, atol=1e-5 * np.abs(jx).max())

    ji = np.asarray(jt2i.decode_images(jm.vae_params, jm.vae_config, jnp.asarray(jx)))
    ti = tt2i.decode_images(tm.vae_params, tm.vae_config, tx).numpy()
    assert ti.dtype == np.uint8 and ti.shape == ji.shape == (3, 16, 16, 3)
    assert np.abs(ti.astype(int) - ji.astype(int)).max() <= 1
    assert not np.array_equal(ti[0], ti[2])  # the slider scale changes the image


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, json.loads(r.read())


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_generate_round_trip(snapshot):
    from PIL import Image

    models = tloader.load_sd(snapshot, dtype=torch.float32, load_vae=True)
    engine = SliderEngine(models, device="cpu", steps=2, image_size=64,
                          compute_dtype=torch.float32)
    jm = jloader.load_sd(snapshot, dtype=jnp.float32, load_vae=True)
    engine.register_slider("age", from_jax_params(jax.tree.map(np.asarray,
                                                               _jax_slider(jm.unet_params))))
    server = make_http_server(engine, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        status, health = _get(base + "/healthz")
        assert status == 200 and health["ok"] and health["sliders"] == ["age"]
        scales = [1.0, -1.0, 0.0]
        status, reply = _post(base + "/generate",
                              {"prompt": "a person", "seed": 3, "slider": "age", "scales": scales})
        assert status == 200
        assert [im["scale"] for im in reply["images"]] == scales
        imgs = [np.asarray(Image.open(io.BytesIO(base64.b64decode(im["png"]))))
                for im in reply["images"]]
        # 64 px -> 8x8 latents; the tiny VAE upsamples once -> 16x16
        assert all(im.shape == (16, 16, 3) and im.dtype == np.uint8 for im in imgs)
        assert not np.array_equal(imgs[0], imgs[1])
        assert _post(base + "/generate", {"prompt": "x", "slider": "nope"})[0] == 404
        assert _post(base + "/generate", {"seed": 1})[0] == 400
        status, err = _post(base + "/sliders", {"name": "c", "compose": []})
        assert status == 501 and "ROADMAP" in err["error"]
        assert engine.stats == {"requests": 1, "batches": 1, "rows": 3}
    finally:
        server.shutdown()
        server.server_close()
        engine.close(timeout=60)
    assert not engine._worker.is_alive()


def test_port_runs_without_jax(snapshot, tmp_path):
    """Import the port and run the tiny slice, then two iterations of the
    training CLI with a resume, with jax, flax, optax, pydantic, PyYAML and
    safetensors made unimportable (the card's machine has none of them), and
    the JAX package too (the port shares no module with it)."""
    (tmp_path / "prompts.yaml").write_text("- target: person\n  positive: old person\n"
                                           "  action: enhance\n  resolution: 64\n")
    (tmp_path / "config.yaml").write_text(
        f"prompts_file: {tmp_path / 'prompts.yaml'}\n"
        f"pretrained_model:\n  name_or_path: {snapshot}\n"
        "network:\n  rank: 2\n  training_method: noxattn\n"
        "train:\n  precision: float32\n  iterations: 2\n  max_denoising_steps: 3\n"
        f"save:\n  name: s\n  path: {tmp_path / 'out'}\n  format: pt\n"
        "tpu:\n  state_checkpoint_every: 1\n")
    code = f"""
import sys
banned = ("jax", "flax", "optax", "pydantic", "yaml", "safetensors", "sliders_tpu")
for name in [m for m in sys.modules if m.split(".")[0] in banned]:
    del sys.modules[name]
for name in banned:
    sys.modules[name] = None
import torch
from sliders_tpu_torch.diffusion.schedulers import make_sampler, make_schedule
from sliders_tpu_torch.models import loader
from sliders_tpu_torch.pipelines import text2image as t2i
from sliders_tpu_torch.serving.server import SliderEngine
m = loader.load_sd({snapshot!r}, dtype=torch.float32, load_vae=True)
cond, uncond = t2i.encode_conditioning(m, "a person", "")
fn = t2i.make_sampling_fn(m.unet_config, make_sampler(make_schedule(), "ddim", 2),
                          compute_dtype=torch.float32)
x = fn(m.unet_params, torch.randn(1, 8, 8, 4), cond, uncond, None, None, 750.0, 7.5)
img = t2i.decode_images(m.vae_params, m.vae_config, x)
assert img.shape == (1, 16, 16, 3) and torch.isfinite(x).all()
from sliders_tpu_torch.cli import train_text_slider as cli
args = ["--config_file", {str(tmp_path / "config.yaml")!r}, "--device", "cpu"]
final = cli.main(cli.build_parser().parse_args(args))
state = {str(tmp_path / "out" / "s_alpha1.0_rank2_noxattn" / "s_alpha1.0_rank2_noxattn_trainstate.pt")!r}
cli.main(cli.build_parser().parse_args(args + ["--resume", state]))
assert all(torch.isfinite(t).all() for e in final.values() for t in e.values())
loaded = [k for k, v in sys.modules.items() if v is not None and k.split(".")[0] in banned]
assert not loaded, loaded
print("ok")
"""
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "resumed from" in res.stdout and "at step 2" in res.stdout
    assert res.stdout.strip().endswith("ok")


def test_read_safetensors_matches_library(tmp_path):
    from safetensors.torch import save_file

    state = {
        "a.weight": torch.randn(3, 5),
        "b": torch.randn(2, 2, 3).bfloat16(),
        "c": torch.arange(7, dtype=torch.int64),
        "d": torch.randn(4).half(),
        "empty": torch.zeros(0, 3),
    }
    path = str(tmp_path / "x.safetensors")
    save_file(state, path, metadata={"k": "v"})
    out = read_safetensors(path)
    assert set(out) == set(state)
    for k, v in state.items():
        assert out[k].dtype == v.dtype and out[k].shape == v.shape
        assert torch.equal(out[k], v)


def test_encode_png_decodes_with_pillow():
    from PIL import Image

    img = np.random.default_rng(0).integers(0, 256, size=(7, 5, 3), dtype=np.uint8)
    dec = np.asarray(Image.open(io.BytesIO(encode_png(img))))
    np.testing.assert_array_equal(dec, img)


@pytest.mark.parametrize(
    "flags",
    [["--xl"], ["--flux"], ["--pp", "2"], ["--dp", "2"], ["--continuous"],
     ["--scheduler", "lms"], ["--scheduler", "euler_a"]],
)
def test_serve_cli_names_unported_flags(flags):
    args = tserve.build_parser().parse_args(["--base", "/nonexistent", *flags])
    with pytest.raises(SystemExit, match="not ported yet|only ddim"):
        tserve.main(args)


def test_engine_refuses_missing_cuda(snapshot):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    models = tloader.load_sd(snapshot, dtype=torch.float32, load_vae=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SliderEngine(models, device="cuda")
