"""Pipeline-parallel FLUX serving (`serve --flux --pp`) on 2 gloo CPU ranks
against a world-1 `FluxSliderEngine` of the same weights (the tiny FLUX
snapshot, f32, 64 px, 2 FlowMatch steps):

- `python -m torch.distributed.run --nproc_per_node 2 -m
  sliders_tpu_torch.cli.serve --flux --pp 2 ...` (jax and the JAX package
  unimportable in the ranks) answering a 5-scale slider sweep and a
  request with no slider over HTTP;
- the engine and its follower built by the CLI's functions on
  `run_ranks`: an in-memory slider, a composition, `close` ending the
  follower, whose forwards and held blocks are counted;
- a slider name registered again while requests for it wait: each
  request keeps the adapter it was queued with on every stage, and the
  followers drop the old one once no request holds it;
- a raise on stage 0 inside a forward ends the pipeline: the request gets
  it, later ones a RuntimeError naming it, and the followers' loop ends
  with an error instead of waiting; under the CLI's `main` the client
  gets a 500, rank 0 exits naming the error and the followers exit too;
- in one process `--flux --pp 2` raises the mesh's error, as the JAX CLI
  does.

Tolerance: every image within 1 level per pixel of the world-1 engine's
(f32 on the CPU: each stage runs the blocks the unsharded forward runs, on
the same rows; the run shows them equal).
"""

import base64
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from helpers import make_tiny_flux_snapshot
from torch_mesh_helpers import (flux_serve_faults_rank, flux_serve_main_fault_rank, flux_serve_rank,
                                free_port, run_ranks)

from sliders_tpu_torch.cli import serve as tserve
from sliders_tpu_torch.lora import io as tio
from sliders_tpu_torch.lora import network as tnet
from sliders_tpu_torch.models import loader as tloader
from sliders_tpu_torch.serving.server import FluxSliderEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP = [-2.0, -1.0, 0.0, 1.0, 2.0]
REQUESTS = [{"prompt": "a photo of a person", "seed": 3, "slider": "s1", "scales": SWEEP},
            {"prompt": "a photo of a dog", "seed": 4}]
ENGINE = {"steps": 2, "image_size": 64, "compute_dtype": torch.float32}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The snapshot, a rank-4 xattn slider file with nonzero up factors, and
    a world-1 engine with the slider loaded."""
    root = tmp_path_factory.mktemp("serve_pp")
    snap = make_tiny_flux_snapshot(str(root / "flux_tiny"))
    models = tloader.load_flux(snap, dtype=torch.float32, load_vae=True)
    w = tnet.create_slider_network(torch.Generator().manual_seed(1), models.transformer_params,
                                   rank=4, train_method="xattn")
    rng = np.random.default_rng(1)
    for e in w.values():
        e["up"] = torch.from_numpy(rng.standard_normal(e["up"].shape).astype(np.float32) * 0.1)
    path = str(root / "s1.safetensors")
    tio.save_slider(path, w)
    engine = FluxSliderEngine(models, device="cpu", **ENGINE)
    engine.load_slider("s1", path)
    yield snap, path, engine
    engine.close(timeout=60)


def _pixels(png: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(png))).astype(int)


def _same_images(got: list, want: list) -> bool:
    """Every image within 1 level per pixel of its world-1 twin; True when
    all are equal byte for byte."""
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert np.abs(_pixels(a) - _pixels(b)).max() <= 1
    return all(a == b for (_, a), (_, b) in zip(got, want))


BLOCK_JAX = """
import runpy, sys
for name in [m for m in sys.modules if m.split(".")[0] in ("jax", "sliders_tpu")]:
    del sys.modules[name]
sys.modules["jax"] = sys.modules["sliders_tpu"] = None
import torch
torch.set_num_threads(1)
sys.argv = ["serve"] + sys.argv[1:]
runpy.run_module("sliders_tpu_torch.cli.serve", run_name="__main__")
"""


def _read_until(proc, marker: str, timeout: float) -> list:
    """The launch's stdout lines up to the one holding `marker` (a reader
    thread, so the wait is bounded)."""
    lines, found = [], threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line)
            if marker in line:
                found.set()

    threading.Thread(target=read, daemon=True).start()
    if not found.wait(timeout):
        raise AssertionError(f"no {marker!r} within {timeout} s:\n{''.join(lines)[-3000:]}")
    return lines


def _ranks_of(script) -> list:
    """The pids of the processes running `script` (the launch's ranks: the
    launcher starts them in sessions of their own)."""
    pids = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if str(script).encode() in f.read():
                    pids.append(int(pid))
        except OSError:
            pass
    return pids


def _stop(proc, script, grace: float = 20.0) -> None:
    """SIGTERM to the launcher (it stops its ranks), then SIGKILL to
    whatever of the launch is left after `grace` seconds."""
    os.killpg(proc.pid, signal.SIGTERM)
    deadline = time.monotonic() + grace
    while time.monotonic() < deadline and (proc.poll() is None or _ranks_of(script)):
        time.sleep(0.2)
    for pid in _ranks_of(script):
        os.kill(pid, signal.SIGKILL)
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
    proc.wait()


def test_serve_flux_pp2_over_http_without_jax(served, tmp_path):
    snap, slider, engine = served
    port = free_port()
    script = tmp_path / "run_blocked.py"
    script.write_text(BLOCK_JAX)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
         "--master_addr", "localhost", "--master_port", str(free_port()), str(script),
         "--flux", "--pp", "2", "--base", snap, "--device", "cpu", "--precision", "float32",
         "--ddim_steps", "2", "--image_size", "64", "--port", str(port), "--no_warmup",
         "--slider", f"s1={slider}"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=str(tmp_path), start_new_session=True)
    try:
        lines = _read_until(proc, "serving on http://", 40)
        replies = []
        for r in REQUESTS:
            req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                         data=json.dumps(r).encode())
            replies.append(json.loads(urllib.request.urlopen(req, timeout=60).read()))
        health = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                                   timeout=20).read())
    finally:
        _stop(proc, script)
    print(f"[mesh] torchrun serve --flux --pp 2: {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    out = "".join(lines)
    assert out.count("mesh dp=1 x tp=1 x pp=2: world 2, backend gloo") == 1
    assert "serving pipeline-parallel over 2 stages" in out
    assert health["family"] == "flux" and health["sliders"] == ["s1"]
    for r, reply in zip(REQUESTS, replies):
        got = [(im["scale"], base64.b64decode(im["png"])) for im in reply["images"]]
        want = engine.generate(r["prompt"], seed=r["seed"], slider=r.get("slider"),
                               scales=r.get("scales"))
        _same_images(got, want)


def test_engine_and_follower_close(served, tmp_path):
    """The CLI's engine (stage 0) and follower on 2 ranks: an in-memory
    slider, a composition of a loaded name and a file, and no slider, each
    equal to the world-1 engine's images; `close` ends the follower, which
    ran 2 forwards a request, held the slider entries of its blocks only
    and stage 1's blocks (doubles 1, singles 1 of TINY's 2 + 2)."""
    snap, slider, engine = served
    requests = [{"prompt": "a person", "seed": 5, "slider": "s2", "scales": [-1.0, 1.0]},
                {"prompt": "a person", "seed": 6, "slider": "c", "scales": [1.0]},
                {"prompt": "a cat", "seed": 7}]
    out = tmp_path / "serve"
    run_ranks(flux_serve_rank, 2, snap, slider, requests, str(out), tag="engine pp=2")
    lead, follow = torch.load(f"{out}.0"), torch.load(f"{out}.1")
    base = engine._lora_base()
    engine.register_slider("s2", tio.load_slider(slider, base))
    engine.load_composition("c", [{"name": "s1", "scale": 0.5}, {"path": slider}])
    for r, got in zip(requests, lead["results"]):
        _same_images(got, engine.generate(r["prompt"], seed=r["seed"], slider=r.get("slider"),
                                          scales=r.get("scales")))
    assert lead["stats"]["requests"] == len(requests)
    assert follow["stats"] == {"forwards": 2 * lead["stats"]["batches"],
                               "batches": lead["stats"]["batches"]}
    assert follow["sliders"] == ["c", "s1", "s2"]
    assert follow["blocks"] == {"transformer_blocks": ["1"], "single_transformer_blocks": ["1"]}


def test_serve_pp2_in_one_process_raises_the_mesh_error(served):
    snap, _, _ = served
    args = tserve.build_parser().parse_args(
        ["--flux", "--pp", "2", "--base", snap, "--device", "cpu"])
    with pytest.raises(ValueError, match=r"mesh 1x1x1x2 needs 2 devices, have 1"):
        tserve.main(args)


FAULT_REQUESTS = [{"prompt": "a person", "seed": 8, "slider": "s", "scales": [1.0, 2.0]},
                  {"prompt": "a dog", "seed": 9, "slider": "s", "scales": [-1.0]},
                  {"prompt": "a person", "seed": 8, "slider": "s", "scales": [1.0, 2.0]},
                  {"prompt": "a cat", "seed": 10}]


@pytest.fixture(scope="module")
def faults(served, tmp_path_factory):
    """One launch of `flux_serve_faults_rank` on 2 ranks: rank 0's and rank
    1's records."""
    snap, slider, _ = served
    out = tmp_path_factory.mktemp("serve_pp_faults") / "faults"
    run_ranks(flux_serve_faults_rank, 2, snap, slider, FAULT_REQUESTS, str(out),
              tag="engine pp=2 faults")
    return torch.load(f"{out}.0"), torch.load(f"{out}.1")


def test_reload_while_queued_keeps_each_request_adapter(served, faults):
    """Requests queued before "s" was registered again run the old adapter
    on both stages, the next one the new adapter, each equal to the
    world-1 engine's images; the follower held both registrations until
    the old one's requests were done, then only the new one."""
    _, slider, engine = served
    lead, follow = faults
    old = tio.load_slider(slider, engine._lora_base())
    engine.register_slider("s_old", old)
    engine.register_slider("s_new", {m: {**e, "up": -e["up"]} for m, e in old.items()})
    for r, got, name in zip(FAULT_REQUESTS, lead["results"], ("s_old", "s_old", "s_new")):
        _same_images(got, engine.generate(r["prompt"], seed=r["seed"], slider=name,
                                          scales=r["scales"]))
    assert [png for _, png in lead["results"][0]] != [png for _, png in lead["results"][2]]
    assert follow["held"] == [["s", "s"]] * 3 + [["s"]]


def test_stage0_raise_ends_the_pipeline(faults):
    """The failing request gets stage 0's error, the next one the
    pipeline's failure at once; the failure hook ran once; the follower's
    loop ended with an error after it announced the forward, not at the
    process group's time-out."""
    lead, follow = faults
    assert lead["errors"][0] == "injected on stage 0"
    assert lead["errors"][1].startswith("the pipeline failed in an earlier call")
    assert lead["failures"] == ["injected on stage 0"] and lead["failed"] == lead["failures"][0]
    assert follow["error"] == "RuntimeError"
    assert follow["stats"] == {"forwards": 2 * 3, "batches": 4}  # the fourth batch's failed


def test_serve_main_stops_when_a_forward_raises(served, tmp_path):
    """The CLI's `main` on 2 ranks with a raise on stage 0 inside a
    forward: the request gets a 500 naming it, rank 0's `main` stops the
    server and exits naming it, and the follower's `main` raises instead of
    waiting for the process group's time-out."""
    snap = served[0]
    out = tmp_path / "main_fault"
    run_ranks(flux_serve_main_fault_rank, 2, snap, free_port(), FAULT_REQUESTS[3], str(out),
              tag="serve main pp=2 fault")
    lead, follow = torch.load(f"{out}.0"), torch.load(f"{out}.1")
    assert lead["status"] == 500 and "injected on stage 0" in lead["reply"]["error"]
    assert lead["main"].startswith("SystemExit: the pipeline failed, stopping the server")
    assert "injected on stage 0" in lead["main"]
    assert follow["main"] == "RuntimeError"
