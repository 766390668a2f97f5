"""The serving engine's sampling slice on the CPU, on the tiny SD
snapshot in f32: the compose route of POST /sliders (lora/compose.py), an
engine of every sampler kind built by `serve --scheduler`, and the rule
that the ancestral samplers (ddpm, euler_a) never coalesce requests, so a
request's image is its solo image, bit for bit."""

import base64
import json
import threading
import urllib.error
import urllib.request

import pytest
import torch
from helpers import make_tiny_snapshot

from sliders_tpu_torch.cli import serve as tserve
from sliders_tpu_torch.lora import compose as tcompose
from sliders_tpu_torch.lora import io as tio
from sliders_tpu_torch.lora.network import create_slider_network
from sliders_tpu_torch.models import loader
from sliders_tpu_torch.serving.server import SliderEngine, make_http_server


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    root = tmp_path_factory.mktemp("sampling") / "sd_tiny"
    make_tiny_snapshot(str(root))
    return str(root)


def _engine(snapshot, scheduler, steps=3):
    models = loader.load_sd(snapshot, dtype=torch.float32, load_vae=True)
    return SliderEngine(models, device="cpu", scheduler=scheduler, steps=steps, image_size=64,
                        compute_dtype=torch.float32, buckets=(1, 2, 4))


def _saved_slider(engine, tmp_path, name, seed, rank=2):
    gen = torch.Generator().manual_seed(seed)
    tree = create_slider_network(gen, engine.models.unet_params, rank=rank,
                                 train_method="noxattn")
    for e in tree.values():
        e["up"] = torch.randn(e["up"].shape, generator=gen) * 0.3
    path = str(tmp_path / f"{name}.safetensors")
    tio.save_slider(path, tree)
    return path, tree


def _post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_engine_compose_route(snapshot, tmp_path):
    """POST /sliders {name, compose: [...]} registers the composition of a
    file and a loaded slider; it serves at scale 1, and scale 0 is the base
    image. A composition naming an unknown slider is a 404, a part with
    neither name nor path a 400."""
    engine = _engine(snapshot, "ddim")
    path_a, wa = _saved_slider(engine, tmp_path, "a", 1)
    _, wb = _saved_slider(engine, tmp_path, "b", 2, rank=3)
    engine.register_slider("b", wb)
    server = make_http_server(engine, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    try:
        code, reply = _post(port, "/sliders", {"name": "ab", "compose": [
            {"path": path_a, "scale": 1.0}, {"name": "b", "scale": -1.0}]})
        assert code == 200 and reply == {"ok": True, "name": "ab"}
        composed = engine.sliders["ab"]
        want = tcompose.compose_sliders([(tio.load_slider(path_a, engine.models.unet_params),
                                          1.0), (wb, -1.0)])
        for m, e in want.items():
            for k in ("down", "up", "alpha"):
                torch.testing.assert_close(composed[m][k], e[k], rtol=0, atol=0)
        assert _post(port, "/sliders", {"name": "x", "compose": [{"name": "nope"}]})[0] == 404
        assert _post(port, "/sliders", {"name": "x", "compose": [{"scale": 1}]})[0] == 400
        assert _post(port, "/sliders", {"compose": []})[0] == 400
        code, reply = _post(port, "/generate", {"prompt": "a person", "seed": 3, "slider": "ab",
                                                "scales": [0.0, 1.0], "start_noise": 1000})
        assert code == 200
        pngs = [base64.b64decode(im["png"]) for im in reply["images"]]
        base = engine.generate("a person", seed=3, scales=[0.0])[0][1]
        assert pngs[0] == base and pngs[1] != base
    finally:
        server.shutdown()
        engine.close(timeout=60)


@pytest.mark.parametrize("kind", ["ddpm", "lms", "euler_a"])
def test_serve_cli_builds_an_engine_of_each_sampler_kind(snapshot, kind):
    """`serve --scheduler` for SD builds an engine on that sampler; the
    ancestral kinds serve one request per denoise."""
    engine = tserve.make_engine(tserve.build_parser().parse_args(
        ["--base", snapshot, "--device", "cpu", "--precision", "float32", "--scheduler", kind,
         "--ddim_steps", "2", "--image_size", "64", "--no_warmup"]))
    try:
        assert engine.sampler.kind == kind and engine.sampler.num_steps == 2
        assert engine._coalesce == (kind == "lms")
        if kind != "ddpm":
            assert engine.sampler.init_noise_sigma > 14.0
    finally:
        engine.close(timeout=60)


def _burst(engine, prompts_seeds):
    """Queue every request before the worker can take one."""
    pend = [engine._make_pending(p, seed=s, scales=[0.0]) for p, s in prompts_seeds]
    engine._submit(pend)
    return [engine._wait(p) for p in pend]


@pytest.mark.parametrize("kind,coalesce", [("euler_a", False), ("ddpm", False), ("ddim", True)])
def test_ancestral_samplers_never_coalesce(snapshot, kind, coalesce):
    """Two requests queued together run as two denoises under euler_a and
    ddpm (one under ddim), and a request's image is its solo image: the
    same seed gives the same PNG bytes, a co-rider changes nothing."""
    engine = _engine(snapshot, kind, steps=2)
    try:
        solo = engine.generate("a person", seed=5, scales=[0.0])[0][1]
        before = engine.stats["batches"]
        a, b = _burst(engine, [("a person", 5), ("a cat", 6)])
        assert engine.stats["batches"] - before == (1 if coalesce else 2)
        assert a[0][1] == solo
        assert engine.generate("a person", seed=5, scales=[0.0])[0][1] == solo
        assert engine.generate("a person", seed=7, scales=[0.0])[0][1] != solo
        if not coalesce:  # no stacked batch can run, so warming one is an error
            engine.register_slider("s", create_slider_network(
                torch.Generator().manual_seed(0), engine.models.unet_params, rank=2,
                train_method="noxattn"))
            with pytest.raises(ValueError, match="never coalesces"):
                engine.warmup(with_slider="s", multi_tenant=True)
    finally:
        engine.close(timeout=60)
