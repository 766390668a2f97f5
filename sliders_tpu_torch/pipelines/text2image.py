"""Text-to-image sampling with slider-scale gating
(port of the per-row path of sliders_tpu/pipelines/text2image.py).

The reference inference twist (generate_images_xl.py:323-362): a stock
denoising loop where the LoRA multiplier is the user's slider scale, and the
slider is OFF while t > start_noise to keep the early structure. Here the
scale, the gate and the guidance strength are per-row (B,) vectors, so one
batched denoise serves many requests; this is the path the serving engine
runs. PyTorch runs the loop eagerly, one UNet forward per step.

Not ported yet: the scalar-scale merged-delta path (lora/merge.py) and the
continuous step function (ROADMAP queue 1, items 7 and 13), and SDXL added
conditioning (item 6).
"""

from __future__ import annotations

import torch

from sliders_tpu_torch.diffusion.guidance import cfg_combine
from sliders_tpu_torch.diffusion.schedulers import Sampler
from sliders_tpu_torch.lora.batch import is_stacked
from sliders_tpu_torch.models import unet2d, vae
from sliders_tpu_torch.ops.basic import SliderLora


def _double_rows(weights: dict) -> dict:
    """CFG-double every leaf of a stacked tree along its row axis."""
    return {name: {k: torch.cat([w, w]) for k, w in entry.items()}
            for name, entry in weights.items()}


def make_sampling_fn(unet_cfg: unet2d.UNetConfig, sampler: Sampler, *,
                     compute_dtype=torch.bfloat16):
    """Build

        fn(unet_params, latents, cond_emb, uncond_emb, lora_weights,
           slider_scale, start_noise, guidance_scale) -> latents

    - `latents`: the initial noise times sampler.init_noise_sigma, NHWC;
    - `lora_weights`: a solo or per-row stacked LoRA tree, or None;
    - `slider_scale`, `start_noise`, `guidance_scale`: per-row (B,) tensors
      (start_noise and guidance may also be scalars); row b's slider is off
      while t > start_noise[b].
    Every step is a CFG-doubled UNet forward ([uncond, cond] rows). The
    no-CFG (Turbo) and guidance-rescale (SDXL) variants come with ROADMAP
    queue 1, items 6 and 7. Everything runs on the latents' device under
    torch.inference_mode()."""
    n = sampler.num_steps

    @torch.inference_mode()
    def fn(unet_params, latents, cond_emb, uncond_emb, lora_weights,
           slider_scale, start_noise, guidance_scale):
        device = latents.device
        x = latents.to(compute_dtype)
        ehs = torch.cat([uncond_emb, cond_emb]).to(device=device, dtype=compute_dtype)
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
            eps = unet2d.apply(unet_params, unet_cfg, x_in, t, ehs, lora=lora)
            eps = cfg_combine(eps, guidance_scale)
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


@torch.inference_mode()
def decode_images(vae_params: dict, vae_cfg: vae.VaeConfig, latents: torch.Tensor) -> torch.Tensor:
    """latents -> uint8 (B, H, W, 3) images. Decodes in f32 whatever the
    weights' dtype (conv2d casts weights to the activation dtype), as the
    JAX package does."""
    imgs = vae.decode(vae_params, vae_cfg, vae.denormalize_latents(vae_cfg, latents).float())
    imgs = torch.clamp(imgs / 2 + 0.5, 0.0, 1.0)
    return (imgs * 255).to(torch.uint8)


def encode_conditioning(models, prompt: str, negative: str):
    """Encode one (prompt, negative) pair: returns (cond [1, 77, D],
    uncond [1, 77, D])."""
    from sliders_tpu_torch.pipelines.encoding import encode_prompts

    if models.is_xl:
        raise NotImplementedError("SDXL conditioning is not ported yet (ROADMAP queue 1, item 6)")
    te = models.text_encoders[0]
    cond = encode_prompts(te.tokenizer, te.params, te.config, [prompt],
                          num_layers=te.clip_skip_layers)
    uncond = encode_prompts(te.tokenizer, te.params, te.config, [negative],
                            num_layers=te.clip_skip_layers)
    return cond, uncond


def tile_conditioning(cond: torch.Tensor, uncond: torch.Tensor, n: int):
    """Tile 1-row conditioning from encode_conditioning to an n-row batch."""
    return cond.expand(n, -1, -1), uncond.expand(n, -1, -1)
