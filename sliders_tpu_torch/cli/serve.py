"""Serve sliders over HTTP on one GPU (port of sliders_tpu/cli/serve.py).

  python -m sliders_tpu_torch.cli.serve --base /path/sd15 \
      --slider age=out/age_last.safetensors --port 8000
  python -m sliders_tpu_torch.cli.serve --xl --base /path/sdxl-base-1.0 \
      --image_size 1024 --slider age=age_xl.safetensors
  python -m sliders_tpu_torch.cli.serve --flux --base /path/flux-dev \
      --image_size 1024 --slider age=age_flux.safetensors
  curl -s localhost:8000/healthz
  curl -s -X POST localhost:8000/generate -d \
      '{"prompt": "photo of a person", "slider": "age", "scales": [-2,0,2]}'

The flags are the JAX CLI's, plus --device. SD and SDXL serve --scheduler
ddim (the default), ddpm, lms or euler_a; the ancestral ddpm and euler_a
serve one request per denoise. SDXL (--xl) serves DDIM 50 at guidance 7.5
with guidance rescale 0.7. FLUX serves 30 FlowMatch steps at guidance 3.5 by
default (--scheduler does not apply) and gates sliders with --skip_till (per
request: "skip_till"). --continuous serves SD and SDXL by step-level
continuous batching (--cont_rows rows in flight, --chunk_steps steps a
device call) on ddim or lms; it refuses FLUX and the ancestral samplers by
name. --dp other than 1 (and --pp without --flux) is not ported yet and
exits with a message naming its ROADMAP item.

--flux --pp N serves FLUX pipeline-parallel over N processes, one stage
each (`parallel/pipeline.py`), launched by torchrun or the SLIDERS_*
variables; rank 0 answers HTTP, encodes, runs stage 0, steps the sampler
and decodes, the other ranks hold their stage's blocks and follow it:

  torchrun --nproc-per-node 2 -m sliders_tpu_torch.cli.serve --flux --pp 2 \
      --base /path/flux-dev --image_size 1024 --slider age=age_flux.safetensors

In one process --pp 2 raises the mesh's error ("needs 2 devices, have 1").
An error inside a pipelined forward stops the server: rank 0 exits naming
it, and each follower's next receive then fails, so every rank ends.

  python -m sliders_tpu_torch.cli.serve --base /path/sd15 --continuous \
      --cont_rows 8 --chunk_steps 5 --slider age=out/age_last.safetensors
"""

import argparse
import threading


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--base", required=True, help="local model snapshot dir")
    p.add_argument("--device", default="cuda", help="torch device to serve on")
    p.add_argument("--xl", action="store_true")
    p.add_argument("--flux", action="store_true")
    p.add_argument("--v2", action="store_true")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--ddim_steps", type=int, default=None, help="denoise steps (default 50)")
    p.add_argument("--scheduler", default="ddim", choices=["ddim", "ddpm", "lms", "euler_a"])
    p.add_argument("--guidance_scale", type=float, default=None, help="CFG scale (default 7.5)")
    p.add_argument("--start_noise", type=float, default=750.0)
    p.add_argument("--skip_till", type=float, default=-1.0,
                   help="FLUX slider gate: the slider is on while step index > skip_till")
    p.add_argument("--pp", type=int, default=1, help="FLUX pipeline-parallel stages")
    p.add_argument("--precision", default="bfloat16")
    p.add_argument("--slider", action="append", default=[], metavar="NAME=CKPT",
                   help="preload a slider checkpoint under NAME (repeatable)")
    p.add_argument("--no_warmup", action="store_true", help="skip the warmup request")
    p.add_argument("--warmup_multi", action="store_true",
                   help="also warm the cross-slider (stacked-adapter) batch path")
    p.add_argument("--buckets", default=None, metavar="N,N,...",
                   help="batch bucket sizes (requests pad up to the next bucket); "
                   "default 1,2,4,8,16")
    p.add_argument("--dp", type=int, default=1, help="data-parallel devices")
    p.add_argument("--continuous", action="store_true",
                   help="step-level continuous batching: keep one fixed row bucket in "
                   "flight, requests join mid-denoise at chunk boundaries and exit when "
                   "their steps complete (best for sustained overlapping traffic; SD/XL "
                   "only, deterministic samplers only, incompatible with --dp)")
    p.add_argument("--cont_rows", type=int, default=None,
                   help="continuous-mode row bucket (default: largest --buckets entry); "
                   "every request's scale sweep must fit in it")
    p.add_argument("--chunk_steps", type=int, default=5,
                   help="continuous-mode denoise steps per device call (admission "
                   "granularity; smaller = lower join latency, more dispatches)")
    return p


def unported_reason(args):
    """The message for a flag this port does not serve yet, else None."""
    if args.pp != 1 and not args.flux:
        return ("--pp: the SD / SDXL engines' multi-device serving is not ported yet "
                "(ROADMAP queue 1, item 15); --pp is FLUX's")
    if args.dp != 1:
        return "--dp: multi-device serving is not ported yet (ROADMAP queue 1, item 15)"
    return None


def refused_reason(args):
    """The message for a combination of flags that cannot be served, else
    None."""
    if args.continuous and args.flux:
        return "--continuous is SD/XL only (the FLUX engine batches at request boundaries)"
    if args.continuous and args.scheduler in ("ddpm", "euler_a"):
        return (f"--continuous does not serve --scheduler {args.scheduler}: the ancestral "
                "samplers draw one noise tensor a step for the whole batch, so a row's image "
                "would depend on its co-riders; use ddim or lms")
    return None


def _dtype(args):
    import torch

    return torch.bfloat16 if args.precision in ("bf16", "bfloat16") else torch.float32


def pipeline_mesh(args):
    """With --flux --pp N (N > 1): join the process group and return the
    1 x 1 x pp mesh (`make_mesh` raises JAX's error when there are too few
    processes) and this rank's device; else (None, --device)."""
    import torch

    from sliders_tpu_torch.parallel import mesh as pm

    device = torch.device(args.device)
    if not (args.flux and args.pp > 1):
        return None, device
    pm.maybe_initialize_distributed(device)
    device = pm.rank_device(device)
    mesh = pm.make_mesh(dp=1, tp=1, pp=args.pp, device=device)
    print(f"serving pipeline-parallel over {args.pp} stages")
    return mesh, device


def make_follower(args, mesh, device, stage=None):
    """A stage past 0 (`FluxStageFollower`) on its blocks of --base, or on
    `stage` = (this stage's params, FluxConfig) for an in-process caller."""
    from sliders_tpu_torch.models import convert, loader
    from sliders_tpu_torch.parallel.pipeline import pp_keep
    from sliders_tpu_torch.serving.server import FluxStageFollower

    if stage is None:
        cfg = loader.flux_config_from_hf(convert.load_component_config(args.base, "transformer"))
        stage = loader.load_flux_transformer(args.base, device=device, dtype=_dtype(args),
                                             keep=pp_keep(mesh, cfg))
    return FluxStageFollower(*stage, mesh, device=device)


def make_engine(args, models=None, mesh=None, device=None):
    """The engine the flags describe (stage 0 of `mesh` under --pp), its
    sliders loaded and (unless --no_warmup) warmed. `models`, if given,
    replaces the load from --base (in-process callers)."""
    reason = unported_reason(args) or refused_reason(args)
    if reason:
        raise SystemExit(reason)

    from sliders_tpu_torch.models import convert, loader
    from sliders_tpu_torch.serving.server import FluxSliderEngine, SliderEngine

    dtype = _dtype(args)
    device = args.device if device is None else device
    buckets = None
    if args.buckets is not None:
        try:
            buckets = tuple(int(b) for b in args.buckets.split(","))
        except ValueError:
            raise SystemExit(f"--buckets wants comma-separated ints (e.g. 5 or 4,8), "
                             f"got {args.buckets!r}")
        if not buckets or any(b < 1 for b in buckets):
            raise SystemExit(f"--buckets wants positive batch sizes, got {args.buckets!r}")

    if args.flux:
        if models is None:
            keep = None
            if mesh is not None:
                from sliders_tpu_torch.parallel.pipeline import pp_keep

                keep = pp_keep(mesh, loader.flux_config_from_hf(
                    convert.load_component_config(args.base, "transformer")))
            models = loader.load_flux(args.base, device=device, dtype=dtype, load_vae=True,
                                      transformer_keep=keep)
        engine = FluxSliderEngine(
            models,
            device=device,
            steps=30 if args.ddim_steps is None else args.ddim_steps,
            image_size=args.image_size,
            guidance_scale=3.5 if args.guidance_scale is None else args.guidance_scale,
            skip_till=args.skip_till,
            compute_dtype=dtype,
            buckets=buckets,
            mesh=mesh,
        )
    else:
        if models is None and args.xl:
            models = loader.load_sdxl(args.base, device=device, dtype=dtype, load_vae=True)
        elif models is None:
            models = loader.load_sd(args.base, device=device, v2=args.v2, dtype=dtype,
                                    load_vae=True)
        engine = SliderEngine(
            models,
            device=device,
            scheduler=args.scheduler,
            steps=50 if args.ddim_steps is None else args.ddim_steps,
            image_size=args.image_size,
            guidance_scale=7.5 if args.guidance_scale is None else args.guidance_scale,
            start_noise=args.start_noise,
            compute_dtype=dtype,
            buckets=buckets,
            continuous=args.continuous,
            continuous_rows=args.cont_rows,
            chunk_steps=args.chunk_steps,
        )
    for spec in args.slider:
        name, _, path = spec.partition("=")
        if not path:
            raise SystemExit(f"--slider wants NAME=CKPT, got {spec!r}")
        engine.load_slider(name, path)
        print(f"loaded slider {name!r} from {path}")

    if not args.no_warmup:
        print("warmup...")
        engine.warmup(with_slider=next(iter(engine.sliders), None),
                      multi_tenant=args.warmup_multi and bool(engine.sliders))
        print("warm.")
    return engine


def main(args):
    reason = unported_reason(args) or refused_reason(args)
    if reason:
        raise SystemExit(reason)
    mesh, device = pipeline_mesh(args)
    if mesh is not None and (not mesh.active or mesh.coord("pp") > 0):
        if mesh.active:  # a stage past 0 follows rank 0 until it closes
            make_follower(args, mesh, device).run()
        mesh.finish()
        return
    engine = make_engine(args, mesh=mesh, device=device)
    from sliders_tpu_torch.serving.server import make_http_server

    server = make_http_server(engine, args.host, args.port)
    channel = getattr(engine, "channel", None)
    if channel is not None:  # an error inside a forward ends the pipeline and the server
        channel.on_failure = lambda e: threading.Thread(target=server.shutdown,
                                                        daemon=True).start()
    print(f"serving on http://{args.host}:{server.server_address[1]}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        engine.close()
        if mesh is not None and channel.failed is None:
            mesh.finish()
    if channel is not None and channel.failed is not None:
        # the other stages wait for messages that never come; this process
        # ends, which fails their receives
        raise SystemExit(f"the pipeline failed, stopping the server: {channel.failed!r}")


if __name__ == "__main__":
    main(build_parser().parse_args())
