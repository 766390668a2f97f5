"""Host-side training loops (port of sliders_tpu/training/driver.py, of
the loop of sliders_tpu/cli/train_flux_slider.py as `train_flux_sliders`,
and of `train_one` of sliders_tpu/cli/train_image_slider.py as
`train_image_sliders`).

The reference `train()` loop (train_lora.py:32-340) around one step
function, with the JAX package's additions and observable behaviour: the
prompt-embedding cache, bucket round-robin with dynamic resolution, the
`{name}_metadata.json` sidecar, periodic slider saves `{name}_{i}steps{ext}`
and the final `{name}_last{ext}` at the same cadence, the same stdout lines,
the NaN guard, and a full train-state checkpoint with resume. The state file
is `{name}_trainstate.pt` (step, LoRA, optimizer state, seed), and under a
process mesh the directory `{name}_trainstate.dcp` (`training/checkpoint.py`,
where the JAX package writes orbax); either resumes at any world size. A
JAX `.msgpack` or orbax state does not resume here, and the JAX package
cannot resume the port's states either.

Under a process mesh (`mesh=`, `parallel/mesh.py`) the text loop's batch is
batch x per_device_batch x dp, as in the JAX loop; only the main rank
writes the slider files, the metadata, the trace and the wandb log, and
every rank takes part in each collective and in the state save.

The text-slider loop honours the JAX loop's `tpu.profile_dir` (a
torch.profiler trace of the whole loop, CPU and CUDA activity, written as a
Chrome trace `{profile_dir}/{name}_loop.pt.trace.json`) and
`logging.use_wandb` (`wandb.init(project=f"LECO_{name}", config=metadata)`,
then the loss, iteration and lr at every log line; wandb is imported only
when asked for). The FLUX, image and fleet loops of the JAX package read
neither key, so these loops ignore both with a printed note.

`train.precision` as the JAX package reads it: the weights load in bf16
under bf16 and in f32 otherwise (`load_dtype_of`, the JAX CLIs' map); the
text loop (and the text fleet, `training/fleet.py`) computes in bf16, f16
(`fp16`) or f32 (`compute_dtype_of`, the JAX loops' map), so fp16 runs the
UNet in f16 on f32 weights and an f32 LoRA, with no loss scaling, as the
JAX package does. The FLUX and image loops (and the image fleet) compute in
the load dtype, as their JAX CLIs do: f32 under fp16, with a printed note.

The FLUX loop takes the same process mesh (`mesh=`, a dp x tp mesh of
`parallel.mesh.training_mesh`): its batch is the prompts' `batch_size`,
split over dp by the step, and only the main rank writes.
"""

from __future__ import annotations

import contextlib
import json
import math
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from sliders_tpu_torch.core.config import RootConfig, to_dict
from sliders_tpu_torch.data.paired_images import PairedImageFolders
from sliders_tpu_torch.diffusion.schedulers import (
    make_flowmatch_sampler,
    make_sampler,
    make_schedule,
)
from sliders_tpu_torch.lora import io as lora_io
from sliders_tpu_torch.lora import network as lnet
from sliders_tpu_torch.models.loader import FluxModels, SDModels
from sliders_tpu_torch.parallel.mesh import whole_params
from sliders_tpu_torch.pipelines.encoding import encode_prompts, encode_prompts_xl
from sliders_tpu_torch.pipelines.flux_t2i import encode_prompts_flux
from sliders_tpu_torch.pipelines.text2image import get_add_time_ids
from sliders_tpu_torch.training import checkpoint
from sliders_tpu_torch.training import optimizers as opt_factory
from sliders_tpu_torch.training.flux_slider import ROLES, make_flux_slider_step
from sliders_tpu_torch.training.image_slider import make_image_slider_step
from sliders_tpu_torch.training.text_slider import (
    SliderTrainState,
    make_text_slider_step,
    stack_prompt_pairs,
)


class PromptEmbedsCache:
    """Encode each unique prompt once (reference PromptEmbedsCache,
    prompt_util.py:31-41 + train_lora.py:109-146): the (77, D) embeddings,
    or for SDXL the pair (text (77, 2048), pooled (1280,))."""

    def __init__(self, models: SDModels):
        self.models = models
        self._cache: dict = {}

    def __getitem__(self, prompt: str):
        if prompt not in self._cache:
            m = self.models
            with torch.no_grad():
                if m.is_xl:
                    tes = m.text_encoders
                    text, pooled = encode_prompts_xl(
                        [te.tokenizer for te in tes], [te.params for te in tes],
                        [te.config for te in tes], [prompt])
                    self._cache[prompt] = (text[0], pooled[0])
                else:
                    te = m.text_encoders[0]
                    emb = encode_prompts(te.tokenizer, te.params, te.config, [prompt],
                                         num_layers=te.clip_skip_layers)
                    self._cache[prompt] = emb[0]
        return self._cache[prompt]


def build_pairs(settings: list, cache: PromptEmbedsCache, is_xl: bool = False,
                resolution_hw=None) -> dict:
    """PromptSettings -> stacked embeddings for the step; erase folds into
    the guidance sign (erase == enhance at -g). SDXL pairs also carry each
    role's `pooled_*`, the static `time_ids` of the pair's resolution
    (`resolution_hw` overrides it for a dynamic-resolution bucket) and the
    `dynamic_crops` flag, on which the step redraws the crop every
    iteration."""
    pairs = []
    for s in settings:
        pair = {}
        for k, prompt in (("target", s.target), ("positive", s.positive),
                          ("neutral", s.neutral), ("unconditional", s.unconditional)):
            if is_xl:
                pair[k], pair[f"pooled_{k}"] = cache[prompt]
            else:
                pair[k] = cache[prompt]
        device = pair["target"].device
        sign = 1.0 if s.action == "enhance" else -1.0
        pair["guidance_signed"] = torch.tensor(sign * s.guidance_scale, dtype=torch.float32,
                                               device=device)
        if is_xl:
            h, w = resolution_hw or (s.resolution, s.resolution)
            pair["time_ids"] = get_add_time_ids(h, w)[0].to(device)
            pair["dynamic_crops"] = torch.tensor(float(s.dynamic_crops), device=device)
        pairs.append(pair)
    return stack_prompt_pairs(pairs)


def random_resolution_in_bucket(rng, bucket_resolution: int = 512) -> tuple:
    """Reference train_util.get_random_resolution_in_bucket
    (train_util.py:407-419): 64-px steps in [res/2, res)."""
    step = 64
    min_step = bucket_resolution // 2 // step
    max_step = bucket_resolution // step
    h = int(rng.integers(min_step, max_step)) * step
    w = int(rng.integers(min_step, max_step)) * step
    return h, w


def _note_f32_under_fp16(config: RootConfig, loop: str) -> None:
    """The FLUX and image loops compute in f32 under fp16: their JAX CLIs
    map every precision but bf16 to f32."""
    if config.train.precision in FP16:
        print(f"precision {config.train.precision}: {loop} runs in float32, as the JAX CLI "
              "maps every precision but bf16 to float32")


def _note_text_loop_only(config: RootConfig) -> None:
    """The FLUX, image and fleet loops neither trace nor log to wandb: the
    JAX package's read neither key."""
    keys = [k for k, on in (("tpu.profile_dir", bool(config.tpu.profile_dir)),
                            ("logging.use_wandb", config.logging.use_wandb)) if on]
    if keys:
        print(f"{' and '.join(keys)}: read by the text-slider loop only; ignored here")


@contextlib.contextmanager
def _loop_trace(profile_dir: str, device: torch.device, name: str):
    """torch.profiler around the training loop when `profile_dir` is set
    (the JAX loop's jax.profiler.start_trace / stop_trace): CPU activity,
    and CUDA activity on a CUDA device, exported as a Chrome trace
    `{profile_dir}/{name}_loop.pt.trace.json` when the loop ends."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    path = Path(profile_dir) / f"{name}_loop.pt.trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    print(f"profile: the loop's trace written to {path}")


def load_train_state(path: str, device, template: Optional[SliderTrainState] = None,
                     mesh=None, rows: Optional[tuple] = None) -> SliderTrainState:
    """A train state written by `train_text_sliders` or `fleet.train_fleet`:
    a `.pt` file, or a `.dcp` directory of a mesh run (read onto
    `template`'s layout, resharded onto `mesh`). `rows` (lo, hi): a fleet
    run's share of the rows, sliced out of a `.pt` state and read as this
    rank's shard of a `.dcp` one. A JAX `.msgpack` or orbax state is
    refused."""
    p = Path(path)
    if p.is_dir() and checkpoint.is_dcp_state(path):
        if template is None:
            raise ValueError(f"{path}: a sharded train state is read onto a template state")
        return checkpoint.restore_sharded(path, template, mesh, row_sharded=rows is not None)
    if p.is_dir() or p.suffix in (".msgpack", ".orbax"):
        raise ValueError(f"{path}: JAX train states (.msgpack, orbax) do not resume in the port "
                         "(ROADMAP queue 1, item 15); resume from the port's own "
                         "{name}_trainstate.pt or {name}_trainstate.dcp")
    state = SliderTrainState.from_state_dict(
        torch.load(p, map_location="cpu", weights_only=True), device)
    if rows is not None:
        lo, hi = rows
        state.lora = _slice_rows(state.lora, lo, hi)
        state.opt_state = _slice_rows(state.opt_state, lo, hi)
    return state


def _slice_rows(tree, lo: int, hi: int):
    """Rows [lo, hi) of every tensor with a leading axis (0-d leaves and
    Python scalars kept)."""
    if isinstance(tree, dict):
        return {k: _slice_rows(v, lo, hi) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.ndim > 0:
        return tree[lo:hi].clone()
    return tree


def save_train_state(stem: Path, state: SliderTrainState, mesh=None,
                     row_sharded: bool = False) -> None:
    """`{stem}.pt` without a mesh; under one, the sharded `{stem}.dcp`
    directory (`checkpoint.save_sharded`; every rank calls)."""
    if mesh is None:
        torch.save(state.state_dict(), f"{stem}.pt")
    else:
        checkpoint.save_sharded(f"{stem}.dcp", state, mesh, row_sharded=row_sharded)


def _param_device(tree: dict) -> torch.device:
    for v in tree.values():
        return _param_device(v) if isinstance(v, dict) else v.device
    raise ValueError("empty parameter tree")


BF16 = ("bf16", "bfloat16")
FP16 = ("fp16", "float16")


def load_dtype_of(config: RootConfig) -> torch.dtype:
    """The dtype the training CLIs load the weights in (the JAX CLIs'
    map): bf16 under bf16, f32 under every other precision, fp16 included.
    The FLUX and image loops also compute in it."""
    return torch.bfloat16 if config.train.precision in BF16 else torch.float32


def compute_dtype_of(config: RootConfig) -> torch.dtype:
    """The text loop's and the text fleet's compute dtype (the JAX
    loops' map): bf16, f16 under fp16, else f32."""
    if config.train.precision in BF16:
        return torch.bfloat16
    return torch.float16 if config.train.precision in FP16 else torch.float32


def _lr_schedule(config: RootConfig):
    return opt_factory.make_lr_schedule(config.train.lr_scheduler, config.train.lr,
                                        config.train.iterations)


def _slider_optimizer(config: RootConfig, trainable_mask: dict):
    """The config's optimizer over its LR schedule, as every training CLI builds it."""
    return opt_factory.make_optimizer(
        config.train.optimizer,
        _lr_schedule(config),
        opt_factory.parse_optimizer_args(config.train.optimizer_args),
        trainable_mask=trainable_mask,
    )


def draw_unet_lora(config: RootConfig, models: SDModels, seed: int, device, mesh=None,
                   **init) -> dict:
    """The UNet's slider LoRA drawn on the CPU from seed + 1 (master
    weights in f32; the compute casts), moved to `device`; whole on every
    rank of a mesh, sized from the UNet's whole weights."""
    lora = lnet.create_slider_network(
        torch.Generator().manual_seed(seed + 1), whole_params(mesh, models.unet_params),
        rank=config.network.rank, alpha=config.network.alpha,
        train_method=config.network.training_method, network_type=config.network.type,
        dtype=torch.float32, **init,
    )
    return {m: {k: t.to(device) for k, t in e.items()} for m, e in lora.items()}


def _unet_lora(config: RootConfig, models: SDModels, seed: int, device, mesh=None,
               **init) -> dict:
    lora = draw_unet_lora(config, models, seed, device, mesh, **init)
    print(f"create LoRA for U-Net: {len(lora)} modules.")
    return lora


def _note_steps_per_call(config: RootConfig) -> None:
    if config.tpu.steps_per_call > 1:
        print("tpu.steps_per_call has no effect here: an eager step dispatches once per iteration")


def _save_due(sj: int, per_steps: int, iterations: int) -> bool:
    """The SD CLIs' `{name}_{i}steps` rule: every `per_steps` (> 0)
    iterations, never at the first or the last."""
    return (per_steps or 0) > 0 and sj % per_steps == 0 and sj not in (
        0, iterations - 1)


def _cpu_lora(lora: dict) -> dict:
    return {m: {k: t.detach().cpu() for k, t in e.items()} for m, e in lora.items()}


def train_text_sliders(
    config: RootConfig,
    prompts: list,
    models: SDModels,
    *,
    resume_from: Optional[str] = None,
    seed: int = 0,
    on_step=None,
    mesh=None,
) -> dict:
    """Run the text-slider training loop on the device of the UNet's
    parameters; returns the final LoRA weights. `on_step(step, state,
    metrics)` is called after every iteration. `mesh`: the process mesh
    the step splits over (`make_text_slider_step`)."""
    tpu = config.tpu
    main = mesh is None or mesh.is_main
    n_dp = 1 if mesh is None else mesh.size("dp")
    device = _param_device(models.unet_params)
    save_dir = Path(config.save.path)
    ext = ".safetensors" if config.save.format == "safetensors" else ".pt"

    # all pairs of one step share a resolution/batch bucket; buckets are
    # drawn on the host each iteration (the reference samples over pairs)
    buckets: dict = {}
    for s in prompts:
        buckets.setdefault((s.resolution, s.batch_size), []).append(s)

    cache = PromptEmbedsCache(models)
    compute_dtype = compute_dtype_of(config)
    schedule = make_schedule(
        prediction_type="v_prediction" if config.pretrained_model.v_pred else "epsilon")
    sampler = make_sampler(schedule, config.train.noise_scheduler,
                           config.train.max_denoising_steps)

    lora = _unet_lora(config, models, seed, device, mesh)
    optimizer = _slider_optimizer(config, lnet.trainable_mask(lora))

    steps: dict = {}
    bucket_pairs: dict = {}

    def get_step(bucket_key, hw):
        """One step function and pair stack per (bucket, resolution)."""
        if (bucket_key, hw) not in steps:
            _, batch = bucket_key
            steps[(bucket_key, hw)] = make_text_slider_step(
                models.unet_config, schedule, sampler, optimizer,
                max_denoising_steps=config.train.max_denoising_steps, resolution=hw,
                batch_size=batch * max(tpu.per_device_batch, 1) * n_dp,
                compute_dtype=compute_dtype, remat=tpu.remat, is_xl=models.is_xl, mesh=mesh,
            )
            bucket_pairs[(bucket_key, hw)] = build_pairs(buckets[bucket_key], cache,
                                                         models.is_xl, resolution_hw=hw)
        return steps[(bucket_key, hw)], bucket_pairs[(bucket_key, hw)]

    state = SliderTrainState.create(seed, lora, optimizer)
    if resume_from is not None:
        state = load_train_state(resume_from, device, template=state, mesh=mesh)
        print(f"resumed from {resume_from} at step {state.step}")

    metadata = {"prompts": [p.to_dict() for p in prompts], "config": to_dict(config)}
    if main:
        save_dir.mkdir(parents=True, exist_ok=True)
        with open(save_dir / f"{config.save.name}_metadata.json", "w") as f:
            json.dump(metadata, f, indent=2)
    _note_steps_per_call(config)

    wandb = None
    if config.logging.use_wandb and main:
        import wandb

        wandb.init(project=f"LECO_{config.save.name}", config=metadata)
    lr_schedule = _lr_schedule(config)

    bucket_keys = list(buckets.keys())
    host_rng = np.random.default_rng(seed)
    t_last = time.perf_counter()
    save_dtype = lora_io.torch_precision(config.save.precision)

    with _loop_trace(tpu.profile_dir if main else "", device, config.save.name):
        for sj in range(state.step, config.train.iterations):
            bk = bucket_keys[host_rng.integers(len(bucket_keys))] if len(bucket_keys) > 1 \
                else bucket_keys[0]
            resolution, _batch = bk
            if any(s.dynamic_resolution for s in buckets[bk]):
                hw = random_resolution_in_bucket(host_rng, resolution)
            else:
                hw = (resolution, resolution)
            step_fn, pairs_for_bucket = get_step(bk, hw)
            state, m = step_fn(state, models.unet_params, pairs_for_bucket)

            if tpu.nan_check and not np.isfinite(m["loss"]):
                raise FloatingPointError(f"non-finite loss at step {sj}: {m}")
            if sj % config.logging.log_every == 0 or sj == config.train.iterations - 1:
                dt = time.perf_counter() - t_last
                t_last = time.perf_counter()
                print(f"step {sj}: loss*1k={m['loss'] * 1000:.4f} t_to={m['t_to']} "
                      f"pair={m['pair']} ({dt:.2f}s since last log)")
                if wandb is not None:
                    wandb.log({"loss": float(m["loss"]), "iteration": sj,
                               "lr": float(lr_schedule(sj))})
            if on_step is not None:
                on_step(sj, state, m)

            if _save_due(sj, config.save.per_steps, config.train.iterations):
                print("Saving...")
                if main:
                    lora_io.save_slider(str(save_dir / f"{config.save.name}_{sj}steps{ext}"),
                                        state.lora, dtype=save_dtype)
            if tpu.state_checkpoint_every and sj % tpu.state_checkpoint_every == 0 and sj != 0:
                save_train_state(save_dir / f"{config.save.name}_trainstate", state, mesh)

    print("Saving...")
    if main:
        lora_io.save_slider(str(save_dir / f"{config.save.name}_last{ext}"), state.lora,
                            dtype=save_dtype)
    print("Done.")
    return _cpu_lora(state.lora)


def train_flux_sliders(
    config: RootConfig,
    prompts: list,
    models: FluxModels,
    *,
    seed: int = 0,
    t5_len: int = 512,
    transformer_guidance: float = 1.0,
    on_step=None,
    lora: Optional[dict] = None,
    mesh=None,
) -> dict:
    """The FLUX text-slider loop of the JAX package's train_flux_slider CLI,
    on the device of the transformer's parameters: an ortho-up LoRA for
    every method but 'full' (drawn on that device), every prompt pair
    encoded once (CLIP pooled + T5 at `t5_len`), one step call per iteration
    (`tpu.steps_per_call` batches dispatch in the JAX package and changes no
    result here), `{name}_{i}steps` saves at the JAX CLI's steps, then
    `{name}_last`. Returns the final LoRA on the CPU; `on_step(step, state,
    metrics)` is called after every iteration. `lora`, if given, is the tree
    to train from in place of a fresh init (copied to the device), so that
    runs on two devices can start from the same factors. `mesh`: the dp x
    tp process mesh the step splits over; the LoRA is drawn whole on every
    rank from the transformer's whole shapes (`whole_params`), and only
    the main rank writes files."""
    main = mesh is None or mesh.is_main
    _note_text_loop_only(config)
    _note_f32_under_fp16(config, "FLUX slider training")
    device = _param_device(models.transformer_params)
    dtype = load_dtype_of(config)
    ortho = config.network.training_method != "full"
    if lora is None:
        lora = lnet.create_slider_network(
            torch.Generator(device=device).manual_seed(seed + 1),
            whole_params(mesh, models.transformer_params),
            rank=config.network.rank, alpha=config.network.alpha,
            train_method=config.network.training_method, ortho_up=ortho,
            dtype=torch.float32, device=device,  # master LoRA weights in f32; the merge casts
        )
    else:
        lora = {m: {k: t.to(device=device, copy=True) for k, t in e.items()}
                for m, e in lora.items()}
    print(f"create LoRA for transformer: {len(lora)} modules (ortho_up={ortho}).")
    mask = lnet.trainable_mask(lora, ortho_up=ortho)
    optimizer = _slider_optimizer(config, mask)
    resolution = prompts[0].resolution
    sampler = make_flowmatch_sampler(num_steps=config.train.max_denoising_steps,
                                     image_seq_len=((resolution // 8) // 2) ** 2)
    step = make_flux_slider_step(
        models.transformer_config, sampler, optimizer, resolution=resolution,
        batch_size=prompts[0].batch_size, transformer_guidance=transformer_guidance,
        compute_dtype=dtype, remat=config.tpu.remat, trainable_mask=mask, mesh=mesh,
    )

    pair_dicts = []
    for s in prompts:
        sign = 1.0 if s.action == "enhance" else -1.0
        pair = {"guidance_signed": torch.tensor(sign * s.guidance_scale, dtype=torch.float32,
                                                device=device)}
        for role in ROLES:
            pooled, t5e = encode_prompts_flux(models, [getattr(s, role)], max_t5_len=t5_len)
            pair[f"{role}_pooled"], pair[f"{role}_t5"] = pooled[0], t5e[0]
        pair_dicts.append(pair)
    pairs = stack_prompt_pairs(pair_dicts)

    state = SliderTrainState.create(seed, lora, optimizer)
    save_dir = Path(config.save.path)
    ext = ".safetensors" if config.save.format == "safetensors" else ".pt"
    if main:
        save_dir.mkdir(parents=True, exist_ok=True)
        with open(save_dir / f"{config.save.name}_metadata.json", "w") as f:
            json.dump({"prompts": [p.to_dict() for p in prompts], "config": to_dict(config)}, f,
                      indent=2)

    iterations, per = config.train.iterations, config.save.per_steps
    for sj in range(iterations):
        state, m = step(state, models.transformer_params, pairs)
        if sj % config.logging.log_every == 0:
            print(f"step {sj}: loss*1k={m['loss'] * 1000:.4f}")
        if on_step is not None:
            on_step(sj, state, m)
        if main and per and sj % per == 0 and sj != 0 and sj != iterations - 1:
            lora_io.save_slider(str(save_dir / f"{config.save.name}_{sj}steps{ext}"), state.lora)
    if main:
        lora_io.save_slider(str(save_dir / f"{config.save.name}_last{ext}"), state.lora)
    print("Done.")
    return _cpu_lora(state.lora)


def to_u8(images: np.ndarray) -> np.ndarray:
    """Reader floats in [-1, 1] -> uint8, rounded half up, as the JAX CLI
    quantises them before the step normalises them back on the device."""
    return np.clip((np.asarray(images, np.float32) + 1.0) * 127.5 + 0.5, 0, 255).astype(np.uint8)


def train_image_sliders(
    config: RootConfig,
    prompts: list,
    models: SDModels,
    folder_main: str,
    folders: list,
    scales: list,
    resolution: int,
    *,
    seed: int = 0,
    on_step=None,
    mesh=None,
) -> dict:
    """The image-slider loop of the JAX package's train_image_slider CLI
    (`train_one`) on the device of the UNet's parameters: the first prompt
    set's positive and neutral embeddings (encoded once), a LoRA with the
    image sliders' kaiming a = sqrt(5) down-init drawn from seed + 1, one
    paired-folder draw from `numpy.random.default_rng(seed)` and one step
    call per iteration, `{name}_{i}steps` saves at the JAX CLI's steps, then
    `{name}_last`. Returns the final LoRA on the CPU; `on_step(step, state,
    metrics)` is called after every iteration, the step's metrics with
    `read_s`, the host seconds of the pair's decode and resize. `mesh`:
    the process mesh the fused +-s batch splits over; only its main rank
    writes files."""
    main = mesh is None or mesh.is_main
    _note_text_loop_only(config)
    _note_f32_under_fp16(config, "image slider training")
    if models.vae_params is None:
        raise ValueError("image sliders encode their images: load the models with load_vae=True")
    device = _param_device(models.unet_params)
    dataset = PairedImageFolders(folder_main, folders, scales)
    cache = PromptEmbedsCache(models)
    settings = prompts[0]  # the reference samples one prompt set per run

    schedule = make_schedule(
        prediction_type="v_prediction" if config.pretrained_model.v_pred else "epsilon")
    sampler = make_sampler(schedule, config.train.noise_scheduler,
                           config.train.max_denoising_steps)
    # image sliders use kaiming a = sqrt(5) down-init (imagesliders/lora.py:96)
    lora = _unet_lora(config, models, seed, device, mesh, init_a=math.sqrt(5))
    optimizer = _slider_optimizer(config, lnet.trainable_mask(lora))
    _note_steps_per_call(config)
    step = make_image_slider_step(
        models.unet_config, models.vae_config, schedule, sampler, optimizer,
        max_denoising_steps=config.train.max_denoising_steps,
        compute_dtype=load_dtype_of(config), remat=config.tpu.remat, is_xl=models.is_xl,
        mesh=mesh,
    )
    state = SliderTrainState.create(seed, lora, optimizer)

    batch_static = {}
    for role, prompt in (("positive", settings.positive), ("neutral", settings.neutral)):
        if models.is_xl:
            batch_static[role], batch_static[f"pooled_{role}"] = cache[prompt]
        else:
            batch_static[role] = cache[prompt]
    if models.is_xl:
        batch_static["time_ids"] = get_add_time_ids(resolution, resolution)[0].to(device)

    host_rng = np.random.default_rng(seed)
    save_dir = Path(config.save.path)
    if main:
        save_dir.mkdir(parents=True, exist_ok=True)
    ext = ".safetensors" if config.save.format == "safetensors" else ".pt"
    iterations, per = config.train.iterations, config.save.per_steps
    for sj in range(iterations):
        t_read = time.perf_counter()
        s, lo, hi = dataset.sample_pair(host_rng, resolution)
        read_s = time.perf_counter() - t_read
        batch = dict(batch_static, scale=s,
                     images_low=torch.from_numpy(to_u8(lo)[None]).to(device),
                     images_high=torch.from_numpy(to_u8(hi)[None]).to(device))
        state, m = step(state, models.unet_params, models.vae_params, batch)
        m["read_s"] = read_s  # the host's decode and resize of the pair
        if sj % config.logging.log_every == 0:
            print(f"step {sj}: loss*1k={m['loss'] * 1000:.4f} scale={m['scale']}")
        if on_step is not None:
            on_step(sj, state, m)
        if _save_due(sj, per, iterations):
            print("Saving...")
            if main:
                lora_io.save_slider(str(save_dir / f"{config.save.name}_{sj}steps{ext}"),
                                    state.lora)
    print("Saving...")
    if main:
        lora_io.save_slider(str(save_dir / f"{config.save.name}_last{ext}"), state.lora)
    print("Done.")
    return _cpu_lora(state.lora)
