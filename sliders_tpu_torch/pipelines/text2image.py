"""Text-to-image sampling with slider-scale gating
(port of the per-row path of sliders_tpu/pipelines/text2image.py).

The reference inference twist (generate_images_xl.py:323-362): a stock
denoising loop where the LoRA multiplier is the user's slider scale, and the
slider is OFF while t > start_noise to keep the early structure. Here the
scale, the gate and the guidance strength are per-row (B,) vectors, so one
batched denoise serves many requests; this is the path the serving engine
runs. PyTorch runs the loop eagerly, one UNet forward per step.

SDXL rides the same loop: its added conditioning (pooled text embeds and
the six size/crop ids, `get_add_time_ids`) is CFG-doubled beside the prompt
embeddings, and the guided noise is rescaled (`guidance_rescale`, 0.7 in the
SDXL server).

Not ported yet: the scalar-scale merged-delta path (lora/merge.py) and the
continuous step function (ROADMAP queue 1, items 7 and 13).
"""

from __future__ import annotations

import contextlib

from typing import Optional

import torch

from sliders_tpu_torch.diffusion.guidance import cfg_combine, rescale_noise_cfg
from sliders_tpu_torch.diffusion.schedulers import Sampler
from sliders_tpu_torch.lora.batch import is_stacked
from sliders_tpu_torch.models import unet2d, vae
from sliders_tpu_torch.ops.basic import SliderLora


def _double_rows(weights: dict) -> dict:
    """CFG-double every leaf of a stacked tree along its row axis."""
    return {name: {k: torch.cat([w, w]) for k, w in entry.items()}
            for name, entry in weights.items()}


def make_sampling_fn(unet_cfg: unet2d.UNetConfig, sampler: Sampler, *,
                     guidance_rescale: float = 0.0, compute_dtype=torch.bfloat16):
    """Build

        fn(unet_params, latents, cond_emb, uncond_emb, lora_weights,
           slider_scale, start_noise, guidance_scale, added_cond=None) -> latents

    - `latents`: the initial noise times sampler.init_noise_sigma, NHWC;
    - `lora_weights`: a solo or per-row stacked LoRA tree, or None;
    - `slider_scale`, `start_noise`, `guidance_scale`: per-row (B,) tensors
      (start_noise and guidance may also be scalars); row b's slider is off
      while t > start_noise[b];
    - `added_cond` (SDXL): {'text_embeds', 'time_ids', 'uncond_text_embeds',
      'uncond_time_ids'}, each with B rows, CFG-doubled as [uncond_*, *].
    Every step is a CFG-doubled UNet forward ([uncond, cond] rows); with
    `guidance_rescale` > 0 the guided noise is rescaled toward the
    conditional prediction's std. The no-CFG (Turbo) variant comes with
    ROADMAP queue 1, item 7. Everything runs on the latents' device under
    torch.inference_mode()."""
    n = sampler.num_steps

    @torch.inference_mode()
    def fn(unet_params, latents, cond_emb, uncond_emb, lora_weights,
           slider_scale, start_noise, guidance_scale, added_cond: Optional[dict] = None):
        device = latents.device
        x = latents.to(compute_dtype)
        ehs = torch.cat([uncond_emb, cond_emb]).to(device=device, dtype=compute_dtype)
        added = None
        if added_cond is not None:
            added = {k: torch.cat([added_cond["uncond_" + k], added_cond[k]]).to(device)
                     for k in ("text_embeds", "time_ids")}
        if lora_weights is not None:
            slider_scale = torch.as_tensor(slider_scale, dtype=torch.float32, device=device)
            if slider_scale.ndim == 0:
                raise NotImplementedError(
                    "a scalar slider scale takes the merged-delta path, not ported yet "
                    "(ROADMAP queue 1, item 7); pass a (B,) scale vector"
                )
            start_noise = torch.as_tensor(start_noise, dtype=torch.float32, device=device)
            if is_stacked(lora_weights):
                lora_weights = _double_rows(lora_weights)
        if isinstance(guidance_scale, torch.Tensor):
            guidance_scale = guidance_scale.to(device)
        timesteps = sampler.timesteps.to(device)
        state = sampler.init_state(x)
        for i in range(n):
            t = timesteps[i]
            lora = None
            if lora_weights is not None:
                mult = torch.where(t > start_noise, 0.0, slider_scale)
                lora = SliderLora(weights=lora_weights, multiplier=torch.cat([mult, mult]))
            x_in = sampler.scale_model_input(torch.cat([x, x]), i).to(compute_dtype)
            eps = unet2d.apply(unet_params, unet_cfg, x_in, t, ehs, added_cond=added, lora=lora)
            eps_text = eps.chunk(2)[1]
            eps = cfg_combine(eps, guidance_scale)
            if guidance_rescale > 0:
                eps = rescale_noise_cfg(eps, eps_text, guidance_rescale)
            x, state = sampler.step(i, eps, x, state)
            x = x.to(compute_dtype)
        return x

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


@contextlib.contextmanager
def decode_precision():
    """cuDNN's and cuBLAS's TF32 flags as the served decode takes them
    (DECODE_CONV_TF32, DECODE_MATMUL_TF32) inside the block, restored after."""
    cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = DECODE_CONV_TF32
    torch.backends.cuda.matmul.allow_tf32 = DECODE_MATMUL_TF32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul


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
