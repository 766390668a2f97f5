"""Host-side training loop (port of sliders_tpu/training/driver.py).

The reference `train()` loop (train_lora.py:32-340) around one step
function, with the JAX package's additions and observable behaviour: the
prompt-embedding cache, bucket round-robin with dynamic resolution, the
`{name}_metadata.json` sidecar, periodic slider saves `{name}_{i}steps{ext}`
and the final `{name}_last{ext}` at the same cadence, the same stdout lines,
the NaN guard, and a full train-state checkpoint with resume. The state file
is `{name}_trainstate.pt` (step, LoRA, optimizer state, seed); a JAX
`.msgpack` or orbax state does not resume here.

Refused with `NotImplementedError` naming their ROADMAP item: `tpu.dp` or
`tpu.tp` above 1 (queue 1, item 15), a non-empty `tpu.profile_dir` and
`logging.use_wandb` (item 16; the card's machine has no wandb), fp16
compute (item 2: the attention kernels take bf16 and f32).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from sliders_tpu_torch.core.config import RootConfig, to_dict
from sliders_tpu_torch.diffusion.schedulers import make_sampler, make_schedule
from sliders_tpu_torch.lora import io as lora_io
from sliders_tpu_torch.lora import network as lnet
from sliders_tpu_torch.models.loader import SDModels
from sliders_tpu_torch.pipelines.encoding import encode_prompts
from sliders_tpu_torch.training import optimizers as opt_factory
from sliders_tpu_torch.training.text_slider import (
    SliderTrainState,
    make_text_slider_step,
    stack_prompt_pairs,
)


class PromptEmbedsCache:
    """Encode each unique prompt once (reference PromptEmbedsCache,
    prompt_util.py:31-41 + train_lora.py:109-146)."""

    def __init__(self, models: SDModels):
        self.models = models
        self._cache: dict = {}

    def __getitem__(self, prompt: str) -> torch.Tensor:
        if prompt not in self._cache:
            if self.models.is_xl:
                raise NotImplementedError("SDXL prompt encoding is not ported yet "
                                          "(ROADMAP queue 1, item 6)")
            te = self.models.text_encoders[0]
            with torch.no_grad():
                emb = encode_prompts(te.tokenizer, te.params, te.config, [prompt],
                                     num_layers=te.clip_skip_layers)
            self._cache[prompt] = emb[0]
        return self._cache[prompt]


def build_pairs(settings: list, cache: PromptEmbedsCache, is_xl: bool = False) -> dict:
    """PromptSettings -> stacked embeddings for the step; erase folds into
    the guidance sign (erase == enhance at -g)."""
    if is_xl:
        raise NotImplementedError("SDXL pairs are not ported yet (ROADMAP queue 1, item 6)")
    pairs = []
    for s in settings:
        pair = {k: cache[prompt] for k, prompt in (
            ("target", s.target), ("positive", s.positive),
            ("neutral", s.neutral), ("unconditional", s.unconditional))}
        sign = 1.0 if s.action == "enhance" else -1.0
        pair["guidance_signed"] = torch.tensor(sign * s.guidance_scale, dtype=torch.float32,
                                               device=pair["target"].device)
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


def _refuse_unported(config: RootConfig) -> None:
    tpu = config.tpu
    if tpu.dp > 1 or tpu.tp > 1:
        raise NotImplementedError(f"tpu.dp={tpu.dp}, tpu.tp={tpu.tp}: data and tensor parallel "
                                  "training are not ported yet (ROADMAP queue 1, item 15)")
    if tpu.profile_dir:
        raise NotImplementedError("tpu.profile_dir: tracing the train loop is not ported yet "
                                  "(ROADMAP queue 1, item 16)")
    if config.logging.use_wandb:
        raise NotImplementedError("logging.use_wandb: wandb logging is not ported "
                                  "(ROADMAP queue 1, item 16)")
    if config.train.precision in ("fp16", "float16"):
        raise NotImplementedError("fp16 compute is not ported: the attention kernels take bf16 "
                                  "and f32 (ROADMAP queue 1, item 2)")


def load_train_state(path: str, device) -> SliderTrainState:
    """A `.pt` train state written by `train_text_sliders`."""
    p = Path(path)
    if p.is_dir() or p.suffix in (".msgpack", ".orbax"):
        raise ValueError(f"{path}: JAX train states (.msgpack, orbax) do not resume in the port; "
                         "resume from the port's own {name}_trainstate.pt")
    return SliderTrainState.from_state_dict(
        torch.load(p, map_location="cpu", weights_only=True), device)


def _param_device(tree: dict) -> torch.device:
    for v in tree.values():
        return _param_device(v) if isinstance(v, dict) else v.device
    raise ValueError("empty parameter tree")


def train_text_sliders(
    config: RootConfig,
    prompts: list,
    models: SDModels,
    *,
    resume_from: Optional[str] = None,
    seed: int = 0,
    on_step=None,
) -> dict:
    """Run the text-slider training loop on the device of the UNet's
    parameters; returns the final LoRA weights. `on_step(step, state,
    metrics)` is called after every iteration."""
    _refuse_unported(config)
    tpu = config.tpu
    device = _param_device(models.unet_params)
    save_dir = Path(config.save.path)
    ext = ".safetensors" if config.save.format == "safetensors" else ".pt"

    # all pairs of one step share a resolution/batch bucket; buckets are
    # drawn on the host each iteration (the reference samples over pairs)
    buckets: dict = {}
    for s in prompts:
        buckets.setdefault((s.resolution, s.batch_size), []).append(s)

    cache = PromptEmbedsCache(models)
    compute_dtype = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16}.get(
        config.train.precision, torch.float32)
    schedule = make_schedule(
        prediction_type="v_prediction" if config.pretrained_model.v_pred else "epsilon")
    sampler = make_sampler(schedule, config.train.noise_scheduler,
                           config.train.max_denoising_steps)

    lora = lnet.create_slider_network(
        torch.Generator().manual_seed(seed + 1), models.unet_params,
        rank=config.network.rank, alpha=config.network.alpha,
        train_method=config.network.training_method, network_type=config.network.type,
        dtype=torch.float32,  # master LoRA weights in f32; the compute casts
    )
    lora = {m: {k: t.to(device) for k, t in e.items()} for m, e in lora.items()}
    print(f"create LoRA for U-Net: {len(lora)} modules.")

    lr_schedule = opt_factory.make_lr_schedule(
        config.train.lr_scheduler, config.train.lr, config.train.iterations)
    optimizer = opt_factory.make_optimizer(
        config.train.optimizer, lr_schedule,
        opt_factory.parse_optimizer_args(config.train.optimizer_args),
        trainable_mask=lnet.trainable_mask(lora),
    )

    steps: dict = {}
    bucket_pairs: dict = {}

    def get_step(bucket_key, hw):
        """One step function and pair stack per (bucket, resolution)."""
        if (bucket_key, hw) not in steps:
            _, batch = bucket_key
            steps[(bucket_key, hw)] = make_text_slider_step(
                models.unet_config, schedule, sampler, optimizer,
                max_denoising_steps=config.train.max_denoising_steps, resolution=hw,
                batch_size=batch * max(tpu.per_device_batch, 1),
                compute_dtype=compute_dtype, remat=tpu.remat,
            )
            bucket_pairs[(bucket_key, hw)] = build_pairs(buckets[bucket_key], cache)
        return steps[(bucket_key, hw)], bucket_pairs[(bucket_key, hw)]

    state = SliderTrainState.create(seed, lora, optimizer)
    if resume_from is not None:
        state = load_train_state(resume_from, device)
        print(f"resumed from {resume_from} at step {state.step}")

    metadata = {"prompts": [p.to_dict() for p in prompts], "config": to_dict(config)}
    save_dir.mkdir(parents=True, exist_ok=True)
    with open(save_dir / f"{config.save.name}_metadata.json", "w") as f:
        json.dump(metadata, f, indent=2)
    if tpu.steps_per_call > 1:
        print("tpu.steps_per_call has no effect here: an eager step dispatches once per iteration")

    bucket_keys = list(buckets.keys())
    host_rng = np.random.default_rng(seed)
    t_last = time.perf_counter()
    save_dtype = lora_io.torch_precision(config.save.precision)

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
        if on_step is not None:
            on_step(sj, state, m)

        if (config.save.per_steps and config.save.per_steps > 0
                and sj % config.save.per_steps == 0 and sj != 0
                and sj != config.train.iterations - 1):
            print("Saving...")
            lora_io.save_slider(str(save_dir / f"{config.save.name}_{sj}steps{ext}"),
                                state.lora, dtype=save_dtype)
        if tpu.state_checkpoint_every and sj % tpu.state_checkpoint_every == 0 and sj != 0:
            torch.save(state.state_dict(), save_dir / f"{config.save.name}_trainstate.pt")

    print("Saving...")
    lora_io.save_slider(str(save_dir / f"{config.save.name}_last{ext}"), state.lora,
                        dtype=save_dtype)
    print("Done.")
    return {m: {k: t.detach().cpu() for k, t in e.items()} for m, e in state.lora.items()}
