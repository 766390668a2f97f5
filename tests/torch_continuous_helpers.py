"""Shared by tests/test_torch_continuous.py and
tests/test_torch_continuous_engine.py: seeded sliders on the tiny snapshot,
a boundary and a continuous engine on one model, and a mid-flight join."""

import time

import torch

from sliders_tpu_torch.lora.network import create_slider_network
from sliders_tpu_torch.models import loader
from sliders_tpu_torch.serving.server import SliderEngine

STEPS = 6


def make_sliders(unet_params):
    def mk(seed, rank, shift):
        w = create_slider_network(torch.Generator().manual_seed(seed), unet_params, rank=rank,
                                  train_method="noxattn")
        return {m: {**e, "up": e["up"] + shift} for m, e in w.items()}

    # "wide": rank 3, pow2 rank bucket 4, above age's and smile's 2
    return {"age": mk(20, 2, 0.4), "smile": mk(21, 2, -0.4), "wide": mk(22, 3, 0.2)}


def make_engines(snapshot, kind, rows=4, chunk=1, steps=STEPS):
    models = loader.load_sd(snapshot, dtype=torch.float32, load_vae=True)
    kw = dict(device="cpu", scheduler=kind, steps=steps, image_size=64,
              compute_dtype=torch.float32, start_noise=1000.0)
    regular = SliderEngine(models, buckets=(rows,), **kw)
    cont = SliderEngine(models, buckets=(1, 2, 4), continuous=True, continuous_rows=rows,
                        chunk_steps=chunk, **kw)
    for name, w in make_sliders(models.unet_params).items():
        regular.register_slider(name, w)
        cont.register_slider(name, w)
    return regular, cont


def pngs(result):
    return [png for _, png in result]


def join_midflight(engine, first, second):
    """Queue `first` and, once the worker has admitted it and waits on the
    device lock, `second`: `second` is in the queue before the first chunk
    of `first`'s batch ends, so it joins that batch mid-flight."""
    p1 = engine._make_pending(*first[:1], **first[1])
    p2 = engine._make_pending(*second[:1], **second[1])
    joins = engine.stats["joins"]
    with engine._lock:
        engine._submit([p1])
        deadline = time.monotonic() + 60
        while True:
            with engine._queue_cv:
                if p1 not in engine._queue:
                    break
            assert time.monotonic() < deadline
            time.sleep(0.001)
        engine._submit([p2])
    return engine._wait(p1), engine._wait(p2), engine.stats["joins"] - joins
