"""The port's continuous serving engine on the CPU, beyond
tests/test_torch_continuous.py: bf16 under LMS and SDXL against the
boundary engine byte for byte, validation and close(), `serve
--continuous`, and three of the four places where the port does not
follow the JAX engine's continuous worker (ROADMAP queue 3; the fourth,
LMS parity under a join, is in tests/test_torch_continuous.py), each with a
test that the JAX logic fails:
  - starvation: a request that cannot join waits at most
    ceil(steps / chunk_steps) chunks; the JAX worker serves it only when the
    compatible traffic stops;
  - error scope: a joiner whose prompt encode fails fails alone; the JAX
    worker fails every request in the batch;
  - the warm-up's join really joins a live batch; the JAX warm-up queues
    its second request after a chunk has run, which with chunk_steps 1 of
    2 steps lands after the first request finished.
"""

import threading
import time

import pytest
import torch
from helpers import make_tiny_snapshot

from sliders_tpu_torch.cli import serve as tserve
from sliders_tpu_torch.lora.network import create_slider_network
from sliders_tpu_torch.models import loader
from sliders_tpu_torch.serving.server import SliderEngine
from torch_continuous_helpers import make_engines, join_midflight, pngs, make_sliders


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    return make_tiny_snapshot(str(tmp_path_factory.mktemp("cont_engine") / "sd_tiny"))


@pytest.fixture(scope="module")
def engines(snapshot):
    regular, cont = make_engines(snapshot, "ddim")
    yield regular, cont
    regular.close(timeout=60)
    cont.close(timeout=60)


def test_bf16_lms_engines_agree(snapshot):
    """bf16 under LMS (the f32 guidance vector promotes the history): a solo
    request and a joiner give the boundary engine's bytes."""
    models = loader.load_sd(snapshot, dtype=torch.bfloat16, load_vae=True)
    kw = dict(device="cpu", scheduler="lms", steps=3, image_size=64,
              compute_dtype=torch.bfloat16, start_noise=1000.0)
    regular = SliderEngine(models, buckets=(2,), **kw)
    cont = SliderEngine(models, continuous=True, continuous_rows=2, chunk_steps=1, **kw)
    try:
        for eng in (regular, cont):
            eng.register_slider("age", make_sliders(models.unet_params)["age"])
        a = ("photo", dict(seed=81, slider="age", scales=[1.0]))
        b = ("a cat", dict(seed=82, slider="age", scales=[-1.0]))
        ra, rb, joins = join_midflight(cont, a, b)
        assert joins == 1
        assert pngs(ra) == pngs(regular.generate(a[0], **a[1]))
        assert pngs(rb) == pngs(regular.generate(b[0], **b[1]))
    finally:
        regular.close(timeout=60)
        cont.close(timeout=60)


def test_xl_continuous_equals_the_boundary_engine(tmp_path_factory):
    """SDXL: the added conditioning (pooled embeds, time ids) rides per row,
    guidance rescale 0.7; a solo request and a mid-flight join give the
    boundary engine's bytes."""
    snap = make_tiny_snapshot(str(tmp_path_factory.mktemp("cont_xl") / "sdxl_tiny"), xl=True)
    models = loader.load_sdxl(snap, dtype=torch.float32, load_vae=True)
    kw = dict(device="cpu", steps=4, image_size=64, compute_dtype=torch.float32,
              start_noise=1000.0)
    regular = SliderEngine(models, buckets=(2,), **kw)
    cont = SliderEngine(models, continuous=True, continuous_rows=2, chunk_steps=2, **kw)
    try:
        w = create_slider_network(torch.Generator().manual_seed(5), models.unet_params,
                                  rank=2, train_method="noxattn")
        for e in w.values():
            e["up"] = e["up"] + 0.3
        for eng in (regular, cont):
            eng.register_slider("s", w)
        a = ("photo", dict(seed=3, slider="s", scales=[1.0]))
        b = ("a cat", dict(seed=4, slider="s", scales=[-1.0]))
        ra, rb, joins = join_midflight(cont, a, b)
        assert joins == 1
        assert pngs(ra) == pngs(regular.generate(a[0], **a[1]))
        assert pngs(rb) == pngs(regular.generate(b[0], **b[1]))
    finally:
        regular.close(timeout=60)
        cont.close(timeout=60)


def test_validation_and_close_drains(snapshot):
    """chunk_steps in [1, steps]; continuous_rows at least the smallest
    bucket (and the buckets cut to it); the ancestral samplers refused;
    close() serves what is queued, then refuses."""
    models = loader.load_sd(snapshot, dtype=torch.float32, load_vae=True)
    kw = dict(device="cpu", steps=3, image_size=64, compute_dtype=torch.float32)
    for bad in (0, 4):
        with pytest.raises(ValueError, match="chunk_steps"):
            SliderEngine(models, continuous=True, chunk_steps=bad, **kw)
    with pytest.raises(ValueError, match="continuous_rows"):
        SliderEngine(models, continuous=True, continuous_rows=1, buckets=(2, 4), **kw)
    for kind in ("ddpm", "euler_a"):
        with pytest.raises(NotImplementedError, match="stochastic"):
            SliderEngine(models, scheduler=kind, continuous=True, **kw)
    eng = SliderEngine(models, continuous=True, continuous_rows=2, chunk_steps=1, **kw)
    assert eng._buckets == (1, 2)
    with pytest.raises(ValueError, match="at most 2 scales"):
        eng.generate("photo", scales=[0.0] * 3)
    pend = [eng._make_pending("photo", seed=s, scales=[0.0]) for s in (1, 2, 3)]
    eng._submit(pend)
    eng.close(timeout=120)
    assert not eng._worker.is_alive()
    assert all(p.event.is_set() and p.error is None and len(p.result) == 1 for p in pend)
    with pytest.raises(RuntimeError, match="closed"):
        eng.generate("photo", scales=[0.0])


def test_serve_cli_continuous(snapshot):
    """`serve --continuous` builds a continuous engine with --cont_rows and
    --chunk_steps; FLUX and the ancestral samplers are refused by name."""
    parse = tserve.build_parser().parse_args
    engine = tserve.make_engine(parse(
        ["--base", snapshot, "--device", "cpu", "--precision", "float32", "--ddim_steps", "3",
         "--image_size", "64", "--continuous", "--cont_rows", "2", "--chunk_steps", "2",
         "--no_warmup"]))
    try:
        assert engine._continuous and engine._cont_rows == 2 and engine._cont_chunk == 2
        assert len(engine.generate("photo", scales=[0.0, 1.0])) == 2
    finally:
        engine.close(timeout=60)
    with pytest.raises(SystemExit, match="SD/XL only"):
        tserve.main(parse(["--base", "/nonexistent", "--flux", "--continuous"]))
    for kind in ("ddpm", "euler_a"):
        with pytest.raises(SystemExit, match=f"--scheduler {kind}"):
            tserve.main(parse(["--base", "/nonexistent", "--continuous", "--scheduler", kind]))


# -- where the port departs from the JAX engine --------------------------------


class _CountingEvent(threading.Event):
    """An Event that records the engine's served-request count when set."""

    def __init__(self, engine):
        super().__init__()
        self.engine, self.served = engine, None

    def set(self):
        self.served = self.engine.stats["requests"]
        super().set()


def test_starved_request_is_served_within_one_denoise(snapshot):
    """2 rows, 2 steps, chunk 1. A1 runs; behind it the queue holds B (no
    slider: another signature) and A2..A9, one scale each. Compatible A's
    would keep the batch busy for ever, one joining as one exits. B waits
    ceil(2 / 1) = 2 chunks; then admission closes, A2's batch drains and B
    runs: B is the 3rd request served. The JAX worker keeps admitting A's
    and serves B 10th, after the last A."""
    models = loader.load_sd(snapshot, dtype=torch.float32, load_vae=True)
    eng = SliderEngine(models, device="cpu", steps=2, image_size=64,
                       compute_dtype=torch.float32, continuous=True, continuous_rows=2,
                       chunk_steps=1)
    try:
        eng.register_slider("age", make_sliders(models.unet_params)["age"])
        a1 = eng._make_pending("photo", seed=1, slider="age", scales=[0.0])
        b = eng._make_pending("photo", seed=2, scales=[0.0])
        rest = [eng._make_pending("photo", seed=3 + i, slider="age", scales=[0.0])
                for i in range(8)]
        for p in [a1, b, *rest]:
            p.event = _CountingEvent(eng)
        served0 = eng.stats["requests"]
        with eng._lock:
            eng._submit([a1])
            while True:
                with eng._queue_cv:
                    if a1 not in eng._queue:
                        break
                time.sleep(0.001)
            eng._submit([b, *rest])
        for p in [a1, b, *rest]:
            eng._wait(p)
        assert b.event.served - served0 == 3, b.event.served - served0
        assert max(p.event.served for p in rest) - served0 == 10
    finally:
        eng.close(timeout=60)


def test_a_failed_joiner_fails_alone(engines):
    """A joiner whose prompt encode raises gets that error; the request in
    flight finishes with its solo images. The JAX worker's batch-wide
    `except` fails both. A failed chunk still fails every request in the
    batch, and the engine serves the next request."""
    regular, cont = engines
    encode = cont._encode

    def flaky(prompt, negative):
        if prompt == "boom":
            raise ValueError("cannot encode this prompt")
        return encode(prompt, negative)

    cont._encode = flaky
    try:
        a = ("photo", dict(seed=71, slider="age", scales=[1.0, 0.0]))
        p1 = cont._make_pending(a[0], **a[1])
        p2 = cont._make_pending("boom", seed=72, slider="age", scales=[1.0])
        with cont._lock:
            cont._submit([p1])
            while True:
                with cont._queue_cv:
                    if p1 not in cont._queue:
                        break
                time.sleep(0.001)
            cont._submit([p2])
        with pytest.raises(ValueError, match="cannot encode"):
            cont._wait(p2)
        assert pngs(cont._wait(p1)) == pngs(regular.generate(a[0], **a[1]))
    finally:
        cont._encode = encode

    step = cont._cont_fn

    def broken(*args):
        raise RuntimeError("device call failed")

    cont._cont_fn = broken
    try:
        with pytest.raises(RuntimeError, match="device call failed"):
            cont.generate("photo", seed=73, scales=[0.0])
    finally:
        cont._cont_fn = step
    assert len(cont.generate("photo", seed=73, scales=[0.0])) == 1


def test_warmup_join_joins_a_live_batch(snapshot):
    """The multi-tenant warm-up's second request joins the first's live
    batch (`stats["joins"]`), at 2 steps and chunk 1, where a request
    queued after the first chunk finds its predecessor finished."""
    regular, cont = make_engines(snapshot, "ddim", rows=2, chunk=1, steps=2)
    try:
        joins = cont.stats["joins"]
        cont.warmup(with_slider="age", n_scales=1, multi_tenant=True)
        assert cont.stats["joins"] == joins + 1
    finally:
        regular.close(timeout=60)
        cont.close(timeout=60)
