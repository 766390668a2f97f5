"""Multi-process helpers of the mesh tests (`tests/test_torch_mesh*.py`):
a launcher of N CPU ranks over gloo, and the rank functions it runs.

This module imports neither jax nor the JAX package, so the spawned ranks
do not either: the parent computes every JAX reference and passes the
port's inputs in as tensors. Every launch picks a free port (the test
workers run side by side), runs torch on one thread in each rank, has its
own join time-out that fails the test instead of hanging the run, and
prints each stage's elapsed time.
"""

from __future__ import annotations

import os
import socket
import sys
import time
import traceback

import torch
import torch.multiprocessing as mp

RANK_TIMEOUT_S = 50.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(fn, rank, world, port, args_path, err_path, launcher):
    if launcher == "sliders":  # the JAX package's variables
        os.environ.update(SLIDERS_NUM_PROCESSES=str(world), SLIDERS_PROCESS_ID=str(rank),
                          SLIDERS_COORDINATOR=f"localhost:{port}")
    else:  # torchrun's
        os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                          LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                          MASTER_PORT=str(port))
    torch.set_num_threads(1)
    try:
        fn(rank, world, *torch.load(args_path, weights_only=False))
    except BaseException:
        with open(f"{err_path}.{rank}", "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn, world: int, *args, tag: str = "", timeout: float = RANK_TIMEOUT_S,
              launcher: str = "torchrun") -> None:
    """Run `fn(rank, world, *args)` in `world` CPU processes (forked from a
    server that has imported torch and the port) joined by torchrun's
    variables, or with `launcher="sliders"` the JAX package's SLIDERS_*
    ones, on a free port; fail (killing every rank) when one fails or when
    they have not all ended within `timeout` seconds."""
    import tempfile

    ctx = mp.get_context("forkserver")
    # the server imports torch and the port once; each rank forks from it
    ctx.set_forkserver_preload(["torch_mesh_helpers", "sliders_tpu_torch.training.fleet",
                                "sliders_tpu_torch.cli.train_image_slider"])
    tmp = tempfile.mkdtemp()
    err_path, args_path = os.path.join(tmp, "rank_error"), os.path.join(tmp, "args.pt")
    torch.save(args, args_path)  # tensors by value, not as shared-memory handles
    port = free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_entry, args=(fn, r, world, port, args_path, err_path, launcher))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = t0 + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.perf_counter()))
            if p.exitcode not in (None, 0):
                break
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
    elapsed = time.perf_counter() - t0
    print(f"[mesh] {tag or fn.__name__}: {world} ranks in {elapsed:.1f} s", file=sys.stderr)
    errors = [open(f"{err_path}.{r}").read() for r in range(world)
              if os.path.exists(f"{err_path}.{r}")]
    if errors:
        raise AssertionError(f"a rank of {tag or fn.__name__} failed:\n{errors[0]}")
    if alive:
        raise AssertionError(f"{tag or fn.__name__}: ranks still running after {timeout} s")
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise AssertionError(f"{tag or fn.__name__}: rank exit codes {bad}")


def run_config(root, snap, out: str, iterations: int, tpu: str) -> str:
    """A text-slider config on the tiny snapshot `snap` (64 px, f32,
    noxattn rank 2, lr 1e-4, 4 denoising steps, per_steps 2), saving under
    `root / out`, with `tpu` the body of its tpu section; returns its path."""
    path = root / f"{out}.yaml"
    path.write_text(
        f"prompts_file: {root / 'age.yaml'}\n"
        f"pretrained_model:\n  name_or_path: {snap}\n"
        "network:\n  rank: 2\n  alpha: 1.0\n  training_method: noxattn\n"
        f"train:\n  precision: float32\n  noise_scheduler: ddim\n  iterations: {iterations}\n"
        "  lr: 0.0001\n  optimizer: adamw\n  lr_scheduler: constant\n  max_denoising_steps: 4\n"
        f"save:\n  name: m\n  path: {root / out}\n  per_steps: 2\n"
        "logging:\n  log_every: 1\n"
        f"tpu:\n  remat: false\n{tpu}")
    return str(path)


def _mesh(dp: int, tp: int):
    from sliders_tpu_torch.parallel import mesh as pm

    pm.maybe_initialize_distributed(torch.device("cpu"))
    mesh = pm.make_mesh(dp=dp, tp=tp)
    mesh.owns_group = True
    return mesh


def _grads_of(loss, leaves):
    from sliders_tpu_torch.training.text_slider import lora_grads

    return lora_grads(loss, leaves)


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------


def collectives_rank(rank, world, out_path):
    """gather_rows / scatter_rows over 3 rows (uneven), copy_to_tp and
    reduce_from_tp forward and backward, all_reduce_grads; rank 0 saves
    what it saw."""
    from sliders_tpu_torch.parallel import collectives as pc

    mesh = _mesh(dp=world, tp=1)
    full = torch.arange(12.0).reshape(3, 4)
    mine = pc.scatter_rows(full.clone().requires_grad_(), mesh)
    gathered = pc.gather_rows(mine.detach() * 2, 3, mesh)
    x = full.clone().requires_grad_()
    y = pc.scatter_rows(x, mesh)
    (y * (rank + 1)).sum().backward()
    grads = pc.all_reduce_grads({"a": {"down": torch.full((2,), float(rank))}}, mesh)
    from sliders_tpu_torch.parallel import mesh as pm

    tp_mesh = pm.make_mesh(dp=1, tp=world)
    tp_mesh.owns_group = True
    z = torch.ones(2, requires_grad=True)
    w = pc.copy_to_tp(z, tp_mesh)
    (w * (rank + 1)).sum().backward()
    u = torch.full((2,), float(rank + 1), requires_grad=True)
    v = pc.reduce_from_tp(u, tp_mesh)
    (v * 3).sum().backward()
    tp_mesh.tp_split = {"a"}
    split = pc.all_reduce_grads({"a": {"up": torch.full((2,), float(rank))}}, tp_mesh)
    if rank == 0:
        torch.save({"rows": mine.shape[0], "gathered": gathered, "scatter_grad": x.grad,
                    "dp_mean": grads["a"]["down"], "copy_grad": z.grad, "reduced": v.detach(),
                    "reduce_grad": u.grad, "tp_sum": split["a"]["up"]}, out_path)
    tp_mesh.finish()


def unet_tp_rank(rank, world, cfg, params, lora, inputs, out_path):
    """The TINY UNet's forward at tp = world on this rank's shards, with
    remat, and the gradient of mean(y^2) with respect to the LoRA made
    whole over tp; rank 0 saves both."""
    from sliders_tpu_torch.models import unet2d
    from sliders_tpu_torch.ops.basic import SliderLora
    from sliders_tpu_torch.parallel import collectives as pc
    from sliders_tpu_torch.parallel import mesh as pm
    from sliders_tpu_torch.training.text_slider import lora_leaves

    mesh = _mesh(dp=1, tp=world)
    sharded = pm.shard_params(mesh, params, tp_enabled=True,
                              heads=unet2d.attention_heads(cfg), geglu=unet2d.geglu_units(cfg))
    leaves = lora_leaves(lora)
    with pc.tensor_parallel(mesh):
        y = unet2d.apply(sharded, cfg, inputs["x"], inputs["t"], inputs["ehs"],
                         added_cond=inputs.get("added"),
                         lora=SliderLora(weights=leaves, multiplier=1.0), remat=True)
        grads = pc.all_reduce_grads(_grads_of((y * y).mean(), leaves), mesh, dp=False)
    if rank == 0:
        torch.save({"y": y.detach(), "grads": grads, "split": sorted(mesh.tp_split)}, out_path)
    mesh.finish()


def text_step(spec: dict, mesh):
    """The port's text step of `spec` (f32) on `mesh` and its fresh state."""
    from sliders_tpu_torch.diffusion import schedulers as tsched
    from sliders_tpu_torch.lora import network as tnet
    from sliders_tpu_torch.models import unet2d
    from sliders_tpu_torch.training import optimizers as topt
    from sliders_tpu_torch.training import text_slider as tts

    sched = tsched.make_schedule(prediction_type=spec.get("prediction_type", "epsilon"))
    tx = topt.make_optimizer("adamw", topt.make_lr_schedule("constant", spec["lr"], 100),
                             trainable_mask=tnet.trainable_mask(spec["lora"]))
    cfg = spec["cfg"]
    step = tts.make_text_slider_step(
        cfg, sched, tsched.make_sampler(sched, "ddim", spec["max_steps"]), tx,
        max_denoising_steps=spec["max_steps"], resolution=spec["resolution"],
        batch_size=spec["batch"], compute_dtype=torch.float32, remat=spec["remat"],
        mesh=mesh, is_xl=cfg.addition_embed_type is not None)
    lora = {m: {k: t.clone() for k, t in e.items()} for m, e in spec["lora"].items()}
    return step, tts.SliderTrainState.create(0, lora, tx)


def text_step_rank(rank, world, dp, tp, spec, out_path):
    """The text step on a dp x tp mesh for len(spec['draws']) iterations
    on the given draws; rank 0 saves the metrics and the LoRA after each."""
    from sliders_tpu_torch.models import unet2d
    from sliders_tpu_torch.parallel import mesh as pm

    mesh = _mesh(dp, tp)
    params = pm.shard_params(mesh, spec["params"], tp_enabled=tp > 1,
                             heads=unet2d.attention_heads(spec["cfg"]),
                             geglu=unet2d.geglu_units(spec["cfg"]))
    step, state = text_step(spec, mesh)
    seen = []
    for draws in spec["draws"]:
        state, m = step(state, params, spec["pairs"], draws=draws)
        seen.append((m, {k: {kk: t.clone() for kk, t in e.items()}
                         for k, e in state.lora.items()}))
    if rank == 0:
        torch.save(seen, out_path)
    mesh.finish()


def image_step_rank(rank, world, spec, out_path):
    """The image step at dp = world on the given batches and draws; rank 0
    saves the metrics and the LoRA after each iteration."""
    from sliders_tpu_torch.diffusion import schedulers as tsched
    from sliders_tpu_torch.lora import network as tnet
    from sliders_tpu_torch.models import vae as tvae
    from sliders_tpu_torch.training import image_slider as tis
    from sliders_tpu_torch.training import optimizers as topt
    from sliders_tpu_torch.training.text_slider import SliderTrainState

    mesh = _mesh(world, 1)
    tx = topt.make_optimizer("adamw", topt.make_lr_schedule("constant", spec["lr"], 100),
                             trainable_mask=tnet.trainable_mask(spec["lora"]))
    sch = tsched.make_schedule()
    step = tis.make_image_slider_step(
        spec["cfg"], tvae.TINY, sch, tsched.make_sampler(sch, "ddim", spec["max_steps"]), tx,
        max_denoising_steps=spec["max_steps"], compute_dtype=torch.float32, remat=False,
        mesh=mesh)
    state = SliderTrainState.create(0, {m: {k: t.clone() for k, t in e.items()}
                                        for m, e in spec["lora"].items()}, tx)
    seen = []
    for batch, draws in zip(spec["batches"], spec["draws"]):
        state, m = step(state, spec["params"], spec["vae"], batch, draws=draws)
        seen.append((m, {k: {kk: t.clone() for kk, t in e.items()}
                         for k, e in state.lora.items()}))
    if rank == 0:
        torch.save(seen, out_path)
    mesh.finish()


def fleet_cli_rank(rank, world, argv, out_path):
    """`train_fleet` (the CLI's main) on this rank; rank 0 saves the rows
    and the per-iteration metrics."""
    from sliders_tpu_torch.cli import train_fleet as cli

    seen = []
    rows = cli.main(cli.build_parser().parse_args(argv),
                    on_step=lambda i, state, m: seen.append((i, m)))
    if rank == 0:
        torch.save({"rows": rows, "metrics": seen}, out_path)


def image_cli_rank(rank, world, runs, out_path):
    """`train_image_slider` (the CLI's main) once per argv of `runs` on one
    process group this rank joins first (each CLI's mesh leaves it to its
    owner); rank 0 saves each run's sliders."""
    import torch.distributed as dist

    from sliders_tpu_torch.cli import train_image_slider as cli
    from sliders_tpu_torch.parallel import mesh as pm

    pm.maybe_initialize_distributed(torch.device("cpu"))
    out = [cli.main(cli.build_parser().parse_args(argv)) for argv in runs]
    if rank == 0:
        torch.save(out, out_path)
    dist.barrier()
    dist.destroy_process_group()


def text_cli_rank(rank, world, argv, out_path):
    """`train_text_slider` (the CLI's main) on this rank; rank 0 saves the
    final LoRA and the per-iteration metrics with each iteration's state."""
    from sliders_tpu_torch.cli import train_text_slider as cli
    from sliders_tpu_torch.training.driver import _cpu_lora

    seen = []

    def on_step(i, state, m):
        seen.append((i, m, state.step, _cpu_lora(state.lora),
                     {k: v for k, v in state.opt_state.items() if not isinstance(v, dict)}))

    final = cli.main(cli.build_parser().parse_args(argv), on_step=on_step)
    if rank == 0:
        torch.save({"final": final, "seen": seen}, out_path)


def checkpoint_rank(rank, world, mode, directory, state_dict, out_path):
    """Save (`mode` 'save') or restore ('restore') a train state at dp =
    world through `training/checkpoint.py`; `state_dict` is the whole
    state (its fleet rows split over dp when it has 'rows')."""
    from sliders_tpu_torch.training import checkpoint as ck
    from sliders_tpu_torch.training.text_slider import SliderTrainState

    mesh = _mesh(world, 1)
    fleet = state_dict.get("rows", False)
    state = SliderTrainState.from_state_dict(state_dict, "cpu")
    if fleet:
        share = state_dict["lora"][next(iter(state_dict["lora"]))]["alpha"].shape[0] // world
        lo, hi = rank * share, (rank + 1) * share
        from sliders_tpu_torch.training.driver import _slice_rows

        state.lora, state.opt_state = (_slice_rows(state.lora, lo, hi),
                                       _slice_rows(state.opt_state, lo, hi))
    if mode == "save":
        ck.save_sharded(directory, state, mesh, row_sharded=fleet)
    else:
        zero = SliderTrainState(step=0, seed=0, lora=_zeros(state.lora),
                                opt_state=_zeros(state.opt_state))
        restored = ck.restore_sharded(directory, zero, mesh, row_sharded=fleet)
        torch.save(restored.state_dict(), f"{out_path}.{rank}")
    mesh.finish()


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    return torch.zeros_like(tree) if isinstance(tree, torch.Tensor) else 0


def _clone(tree):
    return {m: {k: t.detach().clone() for k, t in e.items()} for m, e in tree.items()}


def flux_step_rank(rank, world, dp, tp, spec, out_path):
    """The port's FLUX step (TINY, f32) on a dp x tp mesh, this rank
    holding its tp shard of every block (`parallel.mesh.tp_keep`), for
    len(spec['draws']) iterations on the given draws; rank 0 saves the
    metrics, the LoRA after each and the split modules."""
    from sliders_tpu_torch.diffusion import schedulers as ts
    from sliders_tpu_torch.lora import network as tnet
    from sliders_tpu_torch.models import flux
    from sliders_tpu_torch.parallel import mesh as pm
    from sliders_tpu_torch.training import flux_slider as tfs
    from sliders_tpu_torch.training import optimizers as topt
    from sliders_tpu_torch.training.text_slider import SliderTrainState

    mesh = _mesh(dp, tp)
    params = flux.keep_blocks(spec["params"], pm.tp_keep(mesh, tp > 1))
    mask = tnet.trainable_mask(spec["lora"], ortho_up=True)
    tx = topt.make_optimizer("adamw", topt.make_lr_schedule("constant", spec["lr"], 100),
                             trainable_mask=mask)
    step = tfs.make_flux_slider_step(
        flux.TINY, ts.make_flowmatch_sampler(num_steps=spec["n_steps"], mu=0.5), tx,
        resolution=64, batch_size=spec["batch"], compute_dtype=torch.float32,
        remat=spec["remat"], mesh=mesh, trainable_mask=mask)
    state = SliderTrainState.create(0, _clone(spec["lora"]), tx)
    seen = []
    for draws in spec["draws"]:
        state, m = step(state, params, spec["pairs"], draws=draws)
        seen.append(({k: m[k] for k in ("loss", "grad_norm", "t_to", "pair")},
                     _clone(state.lora)))
    if rank == 0:
        torch.save({"seen": seen, "split": sorted(mesh.tp_split)}, out_path)
    mesh.finish()


def flux_cli_rank(rank, world, argv, out_path):
    """`train_flux_slider` (the CLI's main) on this rank; rank 0 saves the
    final LoRA and the per-iteration metrics."""
    from sliders_tpu_torch.cli import train_flux_slider as cli

    seen = []
    final = cli.main(cli.build_parser().parse_args(argv),
                     on_step=lambda i, state, m: seen.append(
                         (i, {k: m[k] for k in ("loss", "grad_norm", "t_to", "pair")})))
    if rank == 0:
        torch.save({"final": final, "seen": seen}, out_path)


def flux_pp_rank(rank, world, cases, out_path):
    """`flux_apply_pp` on a pp = world mesh, each rank drawing the whole
    tree from the case's seed and keeping its stage (`pp_keep`), for each
    case {cfg, seed, inputs, lora, multiplier, microbatches}; every rank
    calls it with the same arguments. Rank 0 saves the velocities (or the
    ValueError's message) and every rank its block names."""
    from sliders_tpu_torch.models import flux
    from sliders_tpu_torch.ops.basic import SliderLora
    from sliders_tpu_torch.parallel import pipeline as pl

    mesh = _pp_mesh(world)
    out = []
    for case in cases:
        cfg = case["cfg"]
        params = case.get("params")
        if params is None:
            params = flux.init_params(torch.Generator().manual_seed(case["seed"]), cfg,
                                      keep=pl.pp_keep(mesh, cfg))
        else:
            params = pl.flux_pp_params(mesh, params, cfg)
        d = case["inputs"]
        lora = None if case["lora"] is None else SliderLora(case["lora"], case["multiplier"])
        try:
            v = pl.flux_apply_pp(params, cfg, d["packed"], d["t"], d["pooled"], d["ehs"],
                                 d["tids"], d["iids"], mesh, guidance=d["g"], lora=lora,
                                 num_microbatches=case["microbatches"])
        except ValueError as e:
            v = str(e)
        blocks = {f: sorted(int(i) for i in params[f]) for f in pl.FAMILIES}
        out.append((v if rank == 0 else v is None, blocks))
    torch.save(out, f"{out_path}.{rank}")
    mesh.finish()


def _pp_mesh(pp: int):
    from sliders_tpu_torch.parallel import mesh as pm

    pm.maybe_initialize_distributed(torch.device("cpu"))
    mesh = pm.make_mesh(dp=1, tp=1, pp=pp)
    mesh.owns_group = True
    return mesh


def flux_serve_rank(rank, world, snap, slider_path, requests, out_path):
    """A pipeline-parallel FLUX server over world stages built by
    `cli/serve.py`'s functions (`pipeline_mesh`, `make_engine`,
    `make_follower`) on the tiny snapshot: rank 0 registers the slider file
    and an in-memory copy, a composition, serves `requests` through
    `generate` and closes; the followers run until it does. Rank 0 saves
    the PNGs, every rank its stats."""
    from sliders_tpu_torch.cli import serve
    from sliders_tpu_torch.lora import io as lora_io

    args = serve.build_parser().parse_args(
        ["--flux", "--pp", str(world), "--base", snap, "--device", "cpu", "--precision",
         "float32", "--ddim_steps", "2", "--image_size", "64", "--no_warmup",
         "--slider", f"s1={slider_path}"])
    mesh, device = serve.pipeline_mesh(args)
    mesh.owns_group = True
    if mesh.coord("pp") > 0:
        follower = serve.make_follower(args, mesh, device)
        follower.run()
        torch.save({"stats": follower.stats, "sliders": sorted(follower.names.values()),
                    "blocks": {f: sorted(follower.params[f]) for f in
                               ("transformer_blocks", "single_transformer_blocks")}},
                   f"{out_path}.{rank}")
        mesh.finish()
        return
    engine = serve.make_engine(args, mesh=mesh, device=device)
    engine.register_slider("s2", lora_io.load_slider(slider_path, engine._lora_base()))
    engine.load_composition("c", [{"name": "s1", "scale": 0.5}, {"path": slider_path}])
    results = [engine.generate(r["prompt"], seed=r["seed"], slider=r.get("slider"),
                               scales=r.get("scales")) for r in requests]
    engine.close(timeout=120)
    torch.save({"results": results, "stats": dict(engine.stats)}, f"{out_path}.{rank}")
    mesh.finish()


def flux_serve_faults_rank(rank, world, snap, slider_path, requests, out_path):
    """Two faults of a pipeline-parallel FLUX server over world stages (the
    CLI's functions, as `flux_serve_rank`):

    - a name registered again while requests for it wait: rank 0 holds
      the worker (its device lock), queues requests[0] and requests[1]
      for slider "s" (the file's adapter), registers "s" again as the
      adapter with its up factors negated, lets the worker go and serves
      requests[2] (the new "s");
    - a raise on stage 0 inside a forward (its `embed_inputs` replaced):
      the request gets the error, the next one the pipeline's failure, and
      the followers' `run()` raises once rank 0's process has ended.

    Rank 0 saves the PNGs, the errors and the failure hook's calls; the
    followers the slider names they held as each batch came and the error
    that ended their loop."""
    from sliders_tpu_torch.cli import serve
    from sliders_tpu_torch.lora import io as lora_io
    from sliders_tpu_torch.models import flux

    args = serve.build_parser().parse_args(
        ["--flux", "--pp", str(world), "--base", snap, "--device", "cpu", "--precision",
         "float32", "--ddim_steps", "2", "--image_size", "64", "--no_warmup",
         "--slider", f"s={slider_path}"])
    mesh, device = serve.pipeline_mesh(args)
    if mesh.coord("pp") > 0:
        follower = serve.make_follower(args, mesh, device)
        seen = {"held": []}
        real = follower.channel.listen

        def listen():  # the names held as each batch's message comes
            msg = real()
            if msg[0] == "batch":
                seen["held"].append(sorted(follower.names.values()))
            return msg

        follower.channel.listen = listen
        try:
            follower.run()
            seen["error"] = None
        except Exception as e:
            seen["error"] = type(e).__name__
        seen["stats"] = follower.stats
        torch.save(seen, f"{out_path}.{rank}")
        return
    engine = serve.make_engine(args, mesh=mesh, device=device)
    failures = []
    engine.channel.on_failure = failures.append

    def generate(r):
        return engine.generate(r["prompt"], seed=r["seed"], slider=r.get("slider"),
                               scales=r.get("scales"))

    def pending(r):
        return engine._make_pending(r["prompt"], seed=r["seed"], slider=r.get("slider"),
                                    scales=r.get("scales"))

    engine._lock.acquire()  # the worker takes requests[0] and waits for the lock
    first = pending(requests[0])
    engine._submit([first])
    while engine._queue:
        time.sleep(0.01)
    second = pending(requests[1])
    engine._submit([second])
    w = lora_io.load_slider(slider_path, engine._lora_base())
    engine.register_slider("s", {m: {**e, "up": -e["up"]} for m, e in w.items()})
    engine._lock.release()
    results = [engine._wait(first), engine._wait(second)]
    results.append(generate(requests[2]))

    errors = []

    def boom(*a, **k):
        raise RuntimeError("injected on stage 0")

    flux.embed_inputs = boom
    for r in (requests[3], requests[3]):
        try:
            generate(r)
            errors.append(None)
        except RuntimeError as e:
            errors.append(str(e))
    engine.close(timeout=60)
    torch.save({"results": results, "errors": errors,
                "failures": [str(e) for e in failures], "failed": str(engine.failed)},
               f"{out_path}.{rank}")


def flux_serve_main_fault_rank(rank, world, snap, port, request, out_path):
    """`cli/serve.py`'s `main` on world stages with a raise on stage 0
    inside a forward (its `embed_inputs` replaced): rank 0's HTTP client
    posts `request` and gets a 500 naming the error, `main` stops the
    server and raises SystemExit naming it (skipping the mesh's closing
    barrier, which the followers could not reach), and the followers'
    `main` raises once rank 0's process has ended. Every rank saves how its
    `main` ended, rank 0 the reply."""
    import json
    import threading
    import urllib.error
    import urllib.request

    from sliders_tpu_torch.cli import serve
    from sliders_tpu_torch.models import flux

    args = serve.build_parser().parse_args(
        ["--flux", "--pp", str(world), "--base", snap, "--device", "cpu", "--precision",
         "float32", "--ddim_steps", "2", "--image_size", "64", "--no_warmup",
         "--port", str(port)])
    seen = {}

    def client():
        url = f"http://127.0.0.1:{port}"
        while True:
            try:
                urllib.request.urlopen(f"{url}/healthz", timeout=5)
                break
            except OSError:
                time.sleep(0.05)
        req = urllib.request.Request(f"{url}/generate", data=json.dumps(request).encode())
        try:
            urllib.request.urlopen(req, timeout=30)
            seen["status"] = 200
        except urllib.error.HTTPError as e:
            seen["status"], seen["reply"] = e.code, json.loads(e.read())

    if rank == 0:
        def boom(*a, **k):
            raise RuntimeError("injected on stage 0")

        flux.embed_inputs = boom
        asker = threading.Thread(target=client, daemon=True)
        asker.start()
    try:
        serve.main(args)
        seen["main"] = "returned"
    except SystemExit as e:
        seen["main"] = f"SystemExit: {e}"
    except Exception as e:
        seen["main"] = type(e).__name__
    if rank == 0:
        asker.join(30)
    torch.save(seen, f"{out_path}.{rank}")
