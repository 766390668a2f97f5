"""The port's serving slices end to end on the CPU, against the JAX package.

A tiny diffusers snapshot (tests/helpers.make_tiny_snapshot) is loaded by
both loaders; the same injected numpy latents go through 5 DDIM steps at
64 px with a slider at scales [-1, 0, 1] and start_noise 750, then the VAE.
The tiny FLUX snapshot (tests/helpers.make_tiny_flux_snapshot) goes through
both FLUX loaders, prompt encoders (CLIP pooled + T5 with the port's own
tokenizer), 3 FlowMatch steps and the VAE, and is served over HTTP. The
uint8 images may differ by one level (f32 sums in another order can flip a
rounding at the final truncation).
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
from helpers import make_tiny_flux_snapshot, make_tiny_snapshot

from sliders_tpu.diffusion import schedulers as js
from sliders_tpu.lora import network as jnet
from sliders_tpu.models import loader as jloader
from sliders_tpu.pipelines import flux_t2i as jflux_t2i
from sliders_tpu.pipelines import text2image as jt2i
from sliders_tpu_torch.cli import serve as tserve
from sliders_tpu_torch.diffusion import schedulers as ts
from sliders_tpu_torch.models import loader as tloader
from sliders_tpu_torch.models.convert import from_jax_params, read_safetensors
from sliders_tpu_torch.pipelines import flux_t2i as tflux_t2i
from sliders_tpu_torch.pipelines import text2image as tt2i
from sliders_tpu_torch.serving.server import (FluxSliderEngine, SliderEngine, encode_png,
                                              make_http_server)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    return make_tiny_snapshot(str(tmp_path_factory.mktemp("sd_tiny")))


@pytest.fixture(scope="module")
def flux_snapshot(tmp_path_factory):
    return make_tiny_flux_snapshot(str(tmp_path_factory.mktemp("flux_tiny")))


def _jax_slider(params, seed=1, method="noxattn"):
    w = jnet.create_slider_network(jax.random.key(seed), params, rank=4, train_method=method)
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
    tc, tu, tadd = tt2i.encode_conditioning(tm, "a photo of an old person", "", 64)
    assert tadd is None
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)

    jfn = jt2i.make_sampling_fn(jm.unet_config, js.make_sampler(js.make_schedule(), "ddim", 5),
                                compute_dtype=jnp.float32)
    jx = jfn(jm.unet_params, jnp.asarray(lat), jnp.tile(jc, (3, 1, 1)), jnp.tile(ju, (3, 1, 1)),
             jw, jnp.asarray(scales), jnp.full((3,), 750.0), jnp.full((3,), 7.5),
             jax.random.key(0))
    tfn = tt2i.make_sampling_fn(tm.unet_config, ts.make_sampler(ts.make_schedule(), "ddim", 5),
                                compute_dtype=torch.float32)
    tx = tfn(tm.unet_params, torch.from_numpy(lat), *tt2i.tile_conditioning(tc, tu, None, 3)[:2], tw,
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
        assert status == 400 and "at least one" in err["error"]  # an empty composition
        assert engine.stats == {"requests": 1, "batches": 1, "rows": 3}
    finally:
        server.shutdown()
        server.server_close()
        engine.close(timeout=60)
    assert not engine._worker.is_alive()


def test_flux_slice_matches_jax(flux_snapshot):
    """load_flux -> CLIP pooled + T5 (the port's tokenizer against
    T5TokenizerFast) -> 3 FlowMatch steps with an xattn slider at per-row
    scales and skip_till -> the VAE, against the JAX package in f32."""
    jm = jloader.load_flux(flux_snapshot, dtype=jnp.float32, load_vae=True)
    tm = tloader.load_flux(flux_snapshot, dtype=torch.float32, load_vae=True)
    prompt = "a photo of a very old person"
    jpooled, jt5e = jflux_t2i.encode_prompts_flux(jm, [prompt])
    tpooled, tt5e = tflux_t2i.encode_prompts_flux(tm, [prompt])
    np.testing.assert_allclose(tpooled.numpy(), np.asarray(jpooled), rtol=0, atol=1e-5)
    # T5 does not scale its logits: f32 rounding in the softmax of large
    # logits moves the output by up to ~1e-5 of its largest value
    jt5n = np.asarray(jt5e)
    np.testing.assert_allclose(tt5e.numpy(), jt5n, rtol=0, atol=5e-5 * np.abs(jt5n).max())
    assert tt5e.shape == (1, 512, 32)

    jw = _jax_slider(jm.transformer_params, method="xattn")
    tw = from_jax_params(jax.tree.map(np.asarray, jw))
    lat = np.repeat(np.asarray(jflux_t2i.initial_packed_latents(jax.random.key(1), 1, 64, 64, 4)),
                    3, axis=0)
    scales = np.array([-1.0, 0.0, 2.0], np.float32)
    skip = np.array([-1.0, -1.0, 1.0], np.float32)
    g = np.full((3,), 3.5, np.float32)
    jfn = jflux_t2i.make_flux_sampling_fn(jm.transformer_config,
                                          js.make_flowmatch_sampler(3, image_seq_len=16),
                                          latent_hw=8, compute_dtype=jnp.float32)
    jx = np.asarray(jfn(jm.transformer_params, jnp.asarray(lat), jnp.tile(jpooled, (3, 1)),
                        jnp.tile(jt5e, (3, 1, 1)), jw, jnp.asarray(scales), jnp.asarray(skip),
                        jnp.asarray(g)))
    tfn = tflux_t2i.make_flux_sampling_fn(tm.transformer_config,
                                          ts.make_flowmatch_sampler(3, image_seq_len=16),
                                          latent_hw=8, compute_dtype=torch.float32)
    tx = tfn(tm.transformer_params, torch.from_numpy(lat), tpooled.expand(3, -1),
             tt5e.expand(3, -1, -1), tw, torch.from_numpy(scales), torch.from_numpy(skip),
             torch.from_numpy(g))
    np.testing.assert_allclose(tx.numpy(), jx, rtol=0, atol=1e-4 * max(1.0, np.abs(jx).max()))

    from sliders_tpu.models import flux as jflux
    from sliders_tpu_torch.models import flux as tflux

    ji = np.asarray(jt2i.decode_images(jm.vae_params, jm.vae_config,
                                       jflux.unpack_latents(jnp.asarray(jx), 8, 8)))
    ti = tt2i.decode_images(tm.vae_params, tm.vae_config, tflux.unpack_latents(tx, 8, 8)).numpy()
    assert ti.shape == ji.shape == (3, 16, 16, 3)
    assert np.abs(ti.astype(int) - ji.astype(int)).max() <= 1


def test_flux_http_generate_round_trip(flux_snapshot):
    """FluxSliderEngine on the CPU behind the HTTP server: /healthz reports
    the flux family, /generate takes the skip_till alias, a skip_till past
    the last step gives the scale-0 image, and two queued requests for two
    sliders coalesce into one stacked batch."""
    from PIL import Image

    models = tloader.load_flux(flux_snapshot, dtype=torch.float32, load_vae=True)
    engine = FluxSliderEngine(models, device="cpu", steps=2, image_size=64,
                              compute_dtype=torch.float32)
    jm = jloader.load_flux(flux_snapshot, dtype=jnp.float32, load_vae=True)
    for i, name in enumerate(("s1", "s2")):
        engine.register_slider(name, from_jax_params(jax.tree.map(
            np.asarray, _jax_slider(jm.transformer_params, seed=i + 1, method="xattn"))))
    server = make_http_server(engine, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def pixels(reply):
        return [np.asarray(Image.open(io.BytesIO(base64.b64decode(im["png"]))))
                for im in reply["images"]]

    try:
        status, health = _get(base + "/healthz")
        assert status == 200 and health["family"] == "flux" and not health["is_xl"]
        assert health["sliders"] == ["s1", "s2"] and health["steps"] == 2
        status, reply = _post(base + "/generate", {"prompt": "a photo of a person", "seed": 3,
                                                   "slider": "s1", "scales": [-2.0, 0.0, 2.0]})
        assert status == 200
        imgs = pixels(reply)
        assert all(im.shape == (16, 16, 3) for im in imgs)
        assert not np.array_equal(imgs[0], imgs[2])
        status, gated = _post(base + "/generate", {"prompt": "a photo of a person", "seed": 3,
                                                   "slider": "s1", "scales": [2.0],
                                                   "skip_till": 5})
        assert status == 200
        np.testing.assert_array_equal(pixels(gated)[0], imgs[1])

        stats0 = dict(engine.stats)
        p1 = engine._make_pending("a photo", seed=1, slider="s1", scales=[1.0])
        p2 = engine._make_pending("a photo", seed=2, slider="s2", scales=[-1.0, 1.0])
        engine._submit([p1, p2])
        r1, r2 = engine._wait(p1), engine._wait(p2)
        assert [s for s, _ in r1] == [1.0] and [s for s, _ in r2] == [-1.0, 1.0]
        assert engine.stats["batches"] == stats0["batches"] + 1
        assert engine.stats["rows"] == stats0["rows"] + 3
    finally:
        server.shutdown()
        server.server_close()
        engine.close(timeout=60)


def test_flux_engine_decodes_in_slices(flux_snapshot):
    """The FLUX engine's VAE decode in slices of `decode_rows` rows gives
    the images of one whole-bucket decode (f32 on the CPU: within one level
    per pixel, for convs summed in another batch grouping)."""
    from PIL import Image

    models = tloader.load_flux(flux_snapshot, dtype=torch.float32, load_vae=True)
    engine = FluxSliderEngine(models, device="cpu", steps=2, image_size=64,
                              compute_dtype=torch.float32)
    jm = jloader.load_flux(flux_snapshot, dtype=jnp.float32, load_vae=True)
    engine.register_slider("s1", from_jax_params(jax.tree.map(
        np.asarray, _jax_slider(jm.transformer_params, seed=1, method="xattn"))))
    request = {"seed": 5, "slider": "s1", "scales": [-2.0, 0.0, 2.0]}
    try:
        assert engine.decode_rows == 8 * 1024 * 1024 // 64**2
        whole = engine.generate("a photo of a person", **request)
        engine.decode_rows = 1
        sliced = engine.generate("a photo of a person", **request)
    finally:
        engine.close(timeout=60)
    for (s_a, png_a), (s_b, png_b) in zip(whole, sliced):
        a, b = (np.asarray(Image.open(io.BytesIO(png)), dtype=np.int16) for png in (png_a, png_b))
        assert s_a == s_b and a.shape == (16, 16, 3)
        assert np.abs(a - b).max() <= 1


@pytest.fixture(scope="module")
def xl_snapshot(tmp_path_factory):
    return make_tiny_snapshot(str(tmp_path_factory.mktemp("sdxl_tiny")), xl=True)


def test_port_runs_without_jax(snapshot, flux_snapshot, xl_snapshot, tmp_path):
    """Import the port (its kernel wrappers too) and run the tiny slice, a
    GroupNorm, a fused conv call and a layout pin, then two iterations of the
    training CLI with a resume (conv impl 'fused' is set, but at 64 px the
    latents are 8x8, so no resnet passes the gate and the plain path runs),
    then the FLUX and SDXL engines built by `cli/serve.py --flux` and `--xl`
    (`--device cpu`) each serving one request over HTTP, and the FLUX and
    SDXL training CLIs, and the image-slider CLI (SD and `--xl`) on PNG
    folders the port writes and reads itself, with jax, flax, optax,
    pydantic, PyYAML, safetensors and PIL made unimportable (the card's
    machine has none of them), and the JAX package too (the port shares no
    module with it)."""
    (tmp_path / "prompts.yaml").write_text("- target: person\n  positive: old person\n"
                                           "  action: enhance\n  resolution: 64\n")
    (tmp_path / "config.yaml").write_text(
        f"prompts_file: {tmp_path / 'prompts.yaml'}\n"
        f"pretrained_model:\n  name_or_path: {snapshot}\n"
        "network:\n  rank: 2\n  training_method: noxattn\n"
        "train:\n  precision: float32\n  iterations: 2\n  max_denoising_steps: 3\n"
        f"save:\n  name: s\n  path: {tmp_path / 'out'}\n  format: pt\n"
        "tpu:\n  state_checkpoint_every: 1\n")
    (tmp_path / "flux.yaml").write_text(
        f"prompts_file: {tmp_path / 'prompts.yaml'}\n"
        f"pretrained_model:\n  name_or_path: {flux_snapshot}\n"
        "network:\n  rank: 2\n  training_method: xattn\n"
        "train:\n  precision: float32\n  iterations: 2\n  max_denoising_steps: 3\n"
        f"save:\n  name: f\n  path: {tmp_path / 'flux_out'}\n")
    (tmp_path / "xl.yaml").write_text(
        f"prompts_file: {tmp_path / 'prompts.yaml'}\n"
        f"pretrained_model:\n  name_or_path: {xl_snapshot}\n"
        "network:\n  rank: 2\n  training_method: noxattn\n"
        "train:\n  precision: float32\n  iterations: 2\n  max_denoising_steps: 3\n"
        f"save:\n  name: x\n  path: {tmp_path / 'xl_out'}\n")
    for name, snap in (("image", snapshot), ("image_xl", xl_snapshot)):
        (tmp_path / f"{name}.yaml").write_text(
            f"prompts_file: {tmp_path / 'prompts.yaml'}\n"
            f"pretrained_model:\n  name_or_path: {snap}\n"
            "network:\n  rank: 2\n  training_method: noxattn\n"
            "train:\n  precision: float32\n  iterations: 2\n  max_denoising_steps: 5\n"
            f"save:\n  name: {name}\n  path: {tmp_path / 'image_out'}\n")
    code = f"""
import os, sys
banned = ("jax", "flax", "optax", "pydantic", "yaml", "safetensors", "PIL", "sliders_tpu")
for name in [m for m in sys.modules if m.split(".")[0] in banned]:
    del sys.modules[name]
for name in banned:
    sys.modules[name] = None
import torch
from sliders_tpu_torch.ops import _build, conv3x3, group_norm
from sliders_tpu_torch.diffusion.schedulers import make_sampler, make_schedule
from sliders_tpu_torch.models import loader
from sliders_tpu_torch.pipelines import text2image as t2i
from sliders_tpu_torch.serving.server import SliderEngine
m = loader.load_sd({snapshot!r}, dtype=torch.float32, load_vae=True)
cond, uncond, _ = t2i.encode_conditioning(m, "a person", "", 64)
fn = t2i.make_sampling_fn(m.unet_config, make_sampler(make_schedule(), "ddim", 2),
                          compute_dtype=torch.float32)
x = fn(m.unet_params, torch.randn(1, 8, 8, 4), cond, uncond, None, None, 750.0, 7.5)
img = t2i.decode_images(m.vae_params, m.vae_config, x)
assert img.shape == (1, 16, 16, 3) and torch.isfinite(x).all()
assert sorted(_build.LIBRARIES) == ["bwd", "conv", "flash", "fwd", "group_norm", "layout_pin"]
from sliders_tpu_torch.ops import layout_pin
assert torch.equal(layout_pin.LayoutPin.apply(torch.ones(2, 3, 4).transpose(1, 2)),
                   torch.ones(2, 4, 3))
y = group_norm.fused_group_norm(torch.randn(1, 16, 64), torch.ones(64), torch.zeros(64), 32)
assert torch.isfinite(y).all()
from sliders_tpu_torch.ops import basic
basic.set_conv_impl("fused")
x = conv3x3.fused_conv3x3(torch.randn(1, 16, 16, 64), torch.ones(1, 64), torch.zeros(1, 64),
                          torch.randn(128, 64, 3, 3), torch.zeros(128))
assert x.shape == (1, 16, 16, 128)
from sliders_tpu_torch.cli import train_text_slider as cli
args = ["--config_file", {str(tmp_path / "config.yaml")!r}, "--device", "cpu"]
final = cli.main(cli.build_parser().parse_args(args))
state = {str(tmp_path / "out" / "s_alpha1.0_rank2_noxattn" / "s_alpha1.0_rank2_noxattn_trainstate.pt")!r}
cli.main(cli.build_parser().parse_args(args + ["--resume", state]))
assert all(torch.isfinite(t).all() for e in final.values() for t in e.values())
import json, threading, urllib.request
from sliders_tpu_torch.cli import serve
from sliders_tpu_torch.serving.server import make_http_server
engine = serve.make_engine(serve.build_parser().parse_args(
    ["--flux", "--base", {flux_snapshot!r}, "--device", "cpu", "--precision", "float32",
     "--ddim_steps", "2", "--image_size", "64", "--buckets", "1,2", "--no_warmup"]))
server = make_http_server(engine, "127.0.0.1", 0)
threading.Thread(target=server.serve_forever, daemon=True).start()
req = urllib.request.Request(f"http://127.0.0.1:{{server.server_address[1]}}/generate",
                             data=json.dumps({{"prompt": "a person", "scales": [0.0]}}).encode())
reply = json.loads(urllib.request.urlopen(req, timeout=120).read())
assert len(reply["images"]) == 1 and engine.family == "flux", reply
server.shutdown()
engine.close(timeout=60)
engine = serve.make_engine(serve.build_parser().parse_args(
    ["--xl", "--base", {xl_snapshot!r}, "--device", "cpu", "--precision", "float32",
     "--ddim_steps", "2", "--image_size", "64", "--buckets", "1,2", "--no_warmup"]))
server = make_http_server(engine, "127.0.0.1", 0)
threading.Thread(target=server.serve_forever, daemon=True).start()
req = urllib.request.Request(f"http://127.0.0.1:{{server.server_address[1]}}/generate",
                             data=json.dumps({{"prompt": "a person", "scales": [0.0]}}).encode())
reply = json.loads(urllib.request.urlopen(req, timeout=120).read())
assert len(reply["images"]) == 1 and engine.family == "xl", reply
server.shutdown()
engine.close(timeout=60)
xl = cli.main(cli.build_parser().parse_args(
    ["--config_file", {str(tmp_path / "xl.yaml")!r}, "--device", "cpu", "--xl"]))
assert all(torch.isfinite(t).all() for e in xl.values() for t in e.values())
import numpy as np
from sliders_tpu_torch.cli import train_image_slider as icli
from sliders_tpu_torch.serving.server import encode_png
pairs = {str(tmp_path / "pairs")!r}
for folder, val in (("low", 40), ("high", 200)):
    os.makedirs(os.path.join(pairs, folder))
    for n in ("a.png", "b.png"):
        with open(os.path.join(pairs, folder, n), "wb") as f:
            f.write(encode_png(np.full((40, 36, 3), val, np.uint8)))
for name, xl in (("image", []), ("image_xl", ["--xl"])):
    out = icli.main(icli.build_parser().parse_args(
        ["--config_file", os.path.join({str(tmp_path)!r}, name + ".yaml"), "--device", "cpu",
         "--folder_main", pairs, "--folders", "low, high", "--scales", "-1, 1",
         "--resolution", "32", *xl]))
    (lora,) = out.values()
    assert all(torch.isfinite(t).all() for e in lora.values() for t in e.values())
from sliders_tpu_torch.cli import train_flux_slider as fcli
lora = fcli.main(fcli.build_parser().parse_args(
    ["--config_file", {str(tmp_path / "flux.yaml")!r}, "--device", "cpu", "--t5_len", "16"]))
assert all(torch.isfinite(t).all() for e in lora.values() for t in e.values())
loaded = [k for k, v in sys.modules.items() if v is not None and k.split(".")[0] in banned]
assert not loaded, loaded
print("ok")
"""
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "resumed from" in res.stdout and "at step 2" in res.stdout
    assert "create LoRA for transformer: 22 modules (ortho_up=True)." in res.stdout
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
    [["--flux", "--dp", "2"], ["--pp", "2"], ["--dp", "2"], ["--continuous", "--dp", "2"]],
)
def test_serve_cli_names_unported_flags(flags):
    """--dp and an SD engine's --pp name item 15; `--flux --pp 2` is ported
    (tests/test_torch_serve_pp.py)."""
    args = tserve.build_parser().parse_args(["--base", "/nonexistent", *flags])
    with pytest.raises(SystemExit, match="not ported yet"):
        tserve.main(args)


def test_engine_refuses_missing_cuda(snapshot):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    models = tloader.load_sd(snapshot, dtype=torch.float32, load_vae=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SliderEngine(models, device="cuda")
