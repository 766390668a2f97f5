"""Text-to-image sampling with slider-scale gating
(port of sliders_tpu/pipelines/text2image.py).

The reference inference twist (generate_images_xl.py:323-362): a stock
denoising loop where the LoRA multiplier is the user's slider scale, and the
slider is OFF while t > start_noise to keep the early structure. PyTorch
runs the loop eagerly, one UNet forward per step. Two ways to apply a
slider, chosen by the inputs as in the JAX package:

  - per-row: the scale, the gate and the guidance strength are (B,)
    vectors, and the adapters may be per-row stacked, so one batched
    denoise serves many requests (the serving engine, `generate_images`);
  - merged: a 0-d scale with one adapter folds scale * (alpha / rank) *
    up @ down into the targeted weights (lora/merge.py), and each step runs
    on W + gate * delta with gate = (t <= start_noise), a scalar: the
    examples' path. The numbers are the branch's up to the rounding of the
    merged weight into the weights' dtype (bf16: once per weight).

`use_cfg=False` runs one UNet row per latent with no guidance (SDXL-Turbo,
guidance 1). SDXL rides the same loop: its added conditioning (pooled text
embeds and the six size/crop ids, `get_add_time_ids`) goes beside the prompt
embeddings, CFG-doubled when CFG is on, and the guided noise is rescaled
(`guidance_rescale`, 0.7 in the SDXL server).

The ancestral samplers (ddpm, euler_a) draw one noise tensor per step for
the whole batch, as the JAX package's fold_in(key, i) does: from the
caller's `torch.Generator`, or from `step_noise[i]` (a parity test passes
the JAX package's draws there).

`make_continuous_step_fn` is the chunk of the continuous serving engine
(serving/server.py): one fixed row bucket whose rows each sit at their own
step position, advanced `chunk` steps a call.

Not ported yet: the dp `mesh` (ROADMAP queue 1, item 15).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from sliders_tpu_torch.diffusion.guidance import cfg_combine, rescale_noise_cfg
from sliders_tpu_torch.diffusion.schedulers import Sampler
from sliders_tpu_torch.lora.batch import is_stacked
from sliders_tpu_torch.lora.merge import merge_lora_weights
from sliders_tpu_torch.models import unet2d, vae
from sliders_tpu_torch.ops.basic import SliderLora, tf32_flags


def _double_rows(weights: dict) -> dict:
    """CFG-double every leaf of a stacked tree along its row axis."""
    return {name: {k: torch.cat([w, w]) for k, w in entry.items()}
            for name, entry in weights.items()}


def _unet_conditioning(cond_emb, uncond_emb, added_cond: Optional[dict], use_cfg: bool, device,
                       compute_dtype):
    """The UNet's context rows and added conditioning on `device`: [uncond,
    cond] under CFG (SDXL's pooled embeds and time ids alike), else cond."""
    keys = ("text_embeds", "time_ids")
    if use_cfg:
        ehs = torch.cat([uncond_emb, cond_emb])
        added = None if added_cond is None else {
            k: torch.cat([added_cond["uncond_" + k], added_cond[k]]).to(device) for k in keys}
    else:
        ehs = cond_emb
        added = None if added_cond is None else {k: added_cond[k].to(device) for k in keys}
    return ehs.to(device=device, dtype=compute_dtype), added


def _guide(eps: torch.Tensor, guidance_scale, guidance_rescale: float) -> torch.Tensor:
    """CFG over the [uncond, cond] rows of `eps`, rescaled toward the
    conditional prediction's std when `guidance_rescale` > 0."""
    eps_text = eps.chunk(2)[1]
    eps = cfg_combine(eps, guidance_scale)
    if guidance_rescale > 0:
        eps = rescale_noise_cfg(eps, eps_text, guidance_rescale)
    return eps


def make_sampling_fn(unet_cfg: unet2d.UNetConfig, sampler: Sampler, *, use_cfg: bool = True,
                     guidance_rescale: float = 0.0, compute_dtype=torch.bfloat16):
    """Build

        fn(unet_params, latents, cond_emb, uncond_emb, lora_weights,
           slider_scale, start_noise, guidance_scale, added_cond=None,
           generator=None, step_noise=None) -> latents

    - `latents`: the initial noise times sampler.init_noise_sigma, NHWC;
    - `lora_weights`: a solo or per-row stacked LoRA tree, or None;
    - `slider_scale`: a (B,) tensor (per-row multipliers; `start_noise` and
      `guidance_scale` may then be (B,) too: row b's slider is off while
      t > start_noise[b]), or a scalar: with a solo tree the merged-delta
      path, which needs a scalar `start_noise`;
    - `added_cond` (SDXL): {'text_embeds', 'time_ids'} with B rows, and with
      CFG also 'uncond_text_embeds', 'uncond_time_ids', doubled as
      [uncond_*, *];
    - `generator` / `step_noise`: the ancestral draws of ddpm and euler_a,
      one (B, h, w, c) tensor per step (`step_noise[i]` if given);
    - `gated_params` (with no adapter and a scalar `start_noise`): a
      callable giving the parameters that the steps with t <= start_noise
      run on, called once, at the first such step (UCE's interpolated
      weights, evals/baselines.py); the merged path swaps W + delta in the
      same way.
    With `use_cfg` every step is a CFG-doubled UNet forward ([uncond, cond]
    rows) and, with `guidance_rescale` > 0, the guided noise is rescaled
    toward the conditional prediction's std; without it `uncond_emb` and
    `guidance_scale` are unused. Everything runs on the latents' device
    under torch.inference_mode()."""
    n = sampler.num_steps

    @torch.inference_mode()
    def fn(unet_params, latents, cond_emb, uncond_emb, lora_weights, slider_scale,
           start_noise, guidance_scale, added_cond: Optional[dict] = None,
           generator: Optional[torch.Generator] = None, step_noise=None,
           gated_params: Optional[Callable[[], dict]] = None):
        device = latents.device
        x = latents.to(compute_dtype)
        ehs, added = _unet_conditioning(cond_emb, uncond_emb, added_cond, use_cfg, device,
                                        compute_dtype)
        # the parameters of the steps with t <= start_noise, formed at the
        # first such step: W + delta (merged path) or `gated_params()`
        swap, swapped = None, None
        if gated_params is not None:
            if lora_weights is not None:
                raise ValueError("gated_params replaces the adapter: pass lora_weights=None")
            swap, gate_till = gated_params, float(start_noise)
        if lora_weights is not None:
            slider_scale = torch.as_tensor(slider_scale, dtype=torch.float32, device=device)
            start_noise = torch.as_tensor(start_noise, dtype=torch.float32, device=device)
            stacked = is_stacked(lora_weights)
            if stacked and use_cfg:
                lora_weights = _double_rows(lora_weights)
            merge = slider_scale.ndim == 0 and not stacked
            if merge and start_noise.ndim > 0:
                raise ValueError("a scalar slider scale (the merged-delta path) needs a "
                                 "scalar start_noise")
            if merge:
                gate_till = float(start_noise)
                swap = lambda: merge_lora_weights(unet_params, lora_weights,  # noqa: E731
                                                  slider_scale)
        if isinstance(guidance_scale, torch.Tensor):
            guidance_scale = guidance_scale.to(device)
        if sampler.stochastic and generator is None and step_noise is None:
            raise ValueError(f"the {sampler.kind} sampler needs a generator or step_noise")
        timesteps = sampler.timesteps.to(device)
        state = sampler.init_state(x)
        for i in range(n):
            t = timesteps[i]
            params, lora = unet_params, None
            if swap is not None:
                # gate = (t <= start_noise) is 0 or 1: the step runs on W or
                # on the swapped tree, which is formed once
                if float(sampler.timesteps[i]) <= gate_till:
                    if swapped is None:
                        swapped = swap()
                    params = swapped
            elif lora_weights is not None:
                mult = torch.where(t > start_noise, 0.0, slider_scale)
                if use_cfg and mult.ndim > 0:
                    mult = torch.cat([mult, mult])
                lora = SliderLora(weights=lora_weights, multiplier=mult)
            x_in = torch.cat([x, x]) if use_cfg else x
            x_in = sampler.scale_model_input(x_in, i).to(compute_dtype)
            eps = unet2d.apply(params, unet_cfg, x_in, t, ehs, added_cond=added, lora=lora)
            if use_cfg:
                eps = _guide(eps, guidance_scale, guidance_rescale)
            noise = None if step_noise is None else step_noise[i]
            x, state = sampler.step(i, eps, x, state, generator=generator, noise=noise)
            x = x.to(compute_dtype)
        return x

    return fn


def make_continuous_step_fn(unet_cfg: unet2d.UNetConfig, sampler: Sampler, *, chunk: int,
                            use_cfg: bool = True, guidance_rescale: float = 0.0,
                            compute_dtype=torch.bfloat16):
    """Build the chunk of step-level continuous batching:

        fn(unet_params, x, s_state, step_idx, cond_emb, uncond_emb,
           lora_weights, slider_scale, start_noise, guidance_scale,
           added_cond=None) -> (x, s_state)

    - `step_idx` is the (B,) step position of each row at entry; step k of
      the chunk runs row b at i = clip(step_idx[b] + k, 0, n - 1), and a row
      whose step_idx + k >= n is frozen: its latent (row-major) and its
      sampler-state column (history-major, LMS's (ORDER, B, ...) derivs)
      keep their values, so finished rows hold their final latents and free
      slots never move. The caller advances positions on the host, so
      nothing is read back between chunks.
    - `lora_weights` is a per-row stacked tree (lora/batch.py) or None;
      `slider_scale`, `start_noise` and `guidance_scale` are (B,) vectors.
    A row's arithmetic is `make_sampling_fn`'s step with its step index
    gathered per row, so its trajectory is the whole-loop program's at the
    same batch size. The sampler's tables are copied to the latents' device
    once, `step_idx` goes there once a call, and no value is read back
    inside a chunk. The stochastic samplers (ddpm, euler_a) draw one noise
    tensor a step for the whole batch, so a row's image would depend on
    when it joined: they are refused. Runs under torch.inference_mode()."""
    if sampler.stochastic:
        raise NotImplementedError(
            f"continuous batching does not support the stochastic '{sampler.kind}' sampler "
            "(per-step batch-shared noise would make a row's output depend on co-riders); "
            "use ddim or lms")
    n = sampler.num_steps
    on_device: dict = {}

    @torch.inference_mode()
    def fn(unet_params, x, s_state, step_idx, cond_emb, uncond_emb, lora_weights, slider_scale,
           start_noise, guidance_scale, added_cond: Optional[dict] = None):
        device = x.device
        smp = on_device.get(device)
        if smp is None:
            smp = on_device[device] = sampler.to(device)
        step_idx = torch.as_tensor(step_idx, dtype=torch.long)
        if device.type == "cuda" and step_idx.device.type == "cpu":
            # one asynchronous copy a chunk, from pinned memory: no host sync
            step_idx = step_idx.pin_memory().to(device, non_blocking=True)
        step_idx = step_idx.to(device)
        ehs, added = _unet_conditioning(cond_emb, uncond_emb, added_cond, use_cfg, device,
                                        compute_dtype)
        weights = lora_weights
        if weights is not None and use_cfg:
            weights = _double_rows(weights)
        x = x.to(compute_dtype)
        for k in range(chunk):
            idx = step_idx + k
            adv = idx < n
            i = idx.clamp(0, n - 1)
            t = smp.timesteps[i]
            lora = None
            if weights is not None:
                mult = torch.where(t > start_noise, 0.0, slider_scale)
                if use_cfg:
                    mult = torch.cat([mult, mult])
                lora = SliderLora(weights=weights, multiplier=mult)
            x_in = torch.cat([x, x]) if use_cfg else x
            i_in = torch.cat([i, i]) if use_cfg else i
            t_in = torch.cat([t, t]) if use_cfg else t
            x_in = smp.scale_model_input(x_in, i_in).to(compute_dtype)
            eps = unet2d.apply(unet_params, unet_cfg, x_in, t_in, ehs, added_cond=added,
                               lora=lora)
            if use_cfg:
                eps = _guide(eps, guidance_scale, guidance_rescale)
            x_new, s_new = smp.step(i, eps, x, s_state)
            x = torch.where(adv.view((-1,) + (1,) * (x.ndim - 1)), x_new.to(compute_dtype), x)
            s_state = {name: torch.where(adv.view((1, -1) + (1,) * (new.ndim - 2)), new,
                                         s_state[name])
                       for name, new in s_new.items()}
        return x, s_state

    return fn


def initial_latents(generator: torch.Generator, batch: int, height: int, width: int,
                    init_noise_sigma: float, channels: int = 4) -> torch.Tensor:
    """NHWC unit-normal noise * init_noise_sigma, drawn on the generator's
    device (train_util.get_initial_latents semantics)."""
    noise = torch.randn((batch, height // 8, width // 8, channels), generator=generator,
                        device=generator.device)
    return noise * init_noise_sigma


# The served decode's f32 arithmetic, set here and not left to whatever the
# process set last: cuDNN's convs (conv impl 'xla') in TF32, one pass, as
# they ran before the port chose (PyTorch's default); matmuls in full f32.
# The f32-accurate decode is conv impl 'auto', whose conv kernels run
# 3xTF32 whatever these flags say (PERF.md section 7).
DECODE_CONV_TF32 = True
DECODE_MATMUL_TF32 = False


def decode_precision():
    """cuDNN's and cuBLAS's TF32 flags as the served decode takes them
    (DECODE_CONV_TF32, DECODE_MATMUL_TF32) inside the block, restored after."""
    return tf32_flags(DECODE_CONV_TF32, DECODE_MATMUL_TF32)


@torch.inference_mode()
def decode_images(vae_params: dict, vae_cfg: vae.VaeConfig, latents: torch.Tensor) -> torch.Tensor:
    """latents -> uint8 (B, H, W, 3) images. Decodes in f32 whatever the
    weights' dtype (conv2d casts weights to the activation dtype), as the
    JAX package does, under `decode_precision`, so the same latents give
    the same images whatever TF32 flags the process holds."""
    with decode_precision():
        imgs = vae.decode(vae_params, vae_cfg, vae.denormalize_latents(vae_cfg, latents).float())
    imgs = torch.clamp(imgs / 2 + 0.5, 0.0, 1.0)
    return (imgs * 255).to(torch.uint8)


def encode_conditioning(models, prompt: str, negative: str, image_size: int):
    """Encode one (prompt, negative) pair: (cond [1, 77, D], uncond
    [1, 77, D], added) where `added` is None for SD1/2 and, for SDXL, the
    1-row added conditioning of `make_sampling_fn` (pooled embeds of both
    prompts and the static time ids of an `image_size` square)."""
    from sliders_tpu_torch.pipelines.encoding import encode_prompts, encode_prompts_xl

    if models.is_xl:
        tes = models.text_encoders
        args = ([te.tokenizer for te in tes], [te.params for te in tes], [te.config for te in tes])
        cond, pooled_c = encode_prompts_xl(*args, [prompt])
        uncond, pooled_u = encode_prompts_xl(*args, [negative])
        tid = get_add_time_ids(image_size, image_size).to(cond.device)
        return cond, uncond, {"text_embeds": pooled_c, "time_ids": tid,
                              "uncond_text_embeds": pooled_u, "uncond_time_ids": tid}
    te = models.text_encoders[0]
    cond = encode_prompts(te.tokenizer, te.params, te.config, [prompt],
                          num_layers=te.clip_skip_layers)
    uncond = encode_prompts(te.tokenizer, te.params, te.config, [negative],
                            num_layers=te.clip_skip_layers)
    return cond, uncond, None


def tile_conditioning(cond: torch.Tensor, uncond: torch.Tensor, added: Optional[dict], n: int):
    """Tile 1-row conditioning from encode_conditioning to an n-row batch."""
    return (cond.expand(n, -1, -1), uncond.expand(n, -1, -1),
            None if added is None else {k: v.expand(n, -1) for k, v in added.items()})


def get_add_time_ids(height: int, width: int, dynamic_crops: bool = False,
                     draws: Optional[tuple] = None) -> torch.Tensor:
    """SDXL micro-conditioning ids (train_util.get_add_time_ids,
    train_util.py:298-333): (1, 6) f32 (original h, w, crop top, left,
    target h, w). Static: (h, w, 0, 0, h, w). With `dynamic_crops` an
    original size of scale x the target and a crop corner inside it, from
    `draws` = (scale uniform in [1, 3), u_top, u_left uniform in [0, 1)):
    the train step's `step_draws`, or JAX's in a parity test."""
    if not dynamic_crops:
        return torch.tensor([[height, width, 0, 0, height, width]], dtype=torch.float32)
    if draws is None:
        raise ValueError("dynamic_crops needs the crop draws")
    scale, u_top, u_left = (torch.as_tensor(d, dtype=torch.float32) for d in draws)
    oh, ow = torch.floor(height * scale), torch.floor(width * scale)
    top, left = torch.floor(u_top * (oh - height)), torch.floor(u_left * (ow - width))
    h, w = torch.tensor(float(height)), torch.tensor(float(width))
    return torch.stack([oh, ow, top, left, h, w])[None]
