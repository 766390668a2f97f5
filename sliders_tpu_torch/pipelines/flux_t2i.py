"""FLUX text-to-image sampling with slider gating
(port of the per-row path of sliders_tpu/pipelines/flux_t2i.py).

The behaviour of flux-sliders' custom FluxPipeline
(custom_flux_pipeline.py): CLIP-pooled + T5 dual encoding (:201-371), 2x2
latent packing and RoPE ids (:420-455), FlowMatch-Euler with the
resolution-dependent mu shift (:67-137), the distilled guidance embedding
(:687-692), and the slider hook: the LoRA is on only while the step index
exceeds `skip_slider_timestep_till` (:694-731).

Two ways to apply a slider, chosen by the inputs as in the JAX package. A
(B,) scale, gate and guidance, or per-row stacked adapters, ride the LoRA
branch with the multiplier scale * (i > skip_till), so one batched denoise
serves many requests. A 0-d scale with one adapter takes the merged-delta
path: scale * (alpha / rank) * up @ down is folded into the targeted weights
once (lora/merge.py), and step i runs on W + gate * delta with gate =
(i > skip_till), a scalar. The JAX `lax.scan` over steps is a Python loop,
one transformer forward per step. Not ported yet: the pipeline-parallel
`mesh` (ROADMAP queue 1, item 15), refused by name.
"""

from __future__ import annotations

import torch

from sliders_tpu_torch.diffusion.schedulers import FlowMatchSampler
from sliders_tpu_torch.lora.batch import is_stacked
from sliders_tpu_torch.lora.merge import merge_lora_weights
from sliders_tpu_torch.models import clip_text, flux, t5
from sliders_tpu_torch.ops.basic import SliderLora


@torch.no_grad()
def encode_prompts_flux(models, prompts: list[str], t5_ids=None, max_t5_len: int = 512):
    """(pooled (B, 768), t5_embeds (B, L, 4096)) on the encoders' device:
    CLIP gives only the pooled projection, T5 the sequence features
    (custom_flux_pipeline.py:201-287). `t5_ids` (B, L) skips the T5
    tokenizer."""
    clip = models.clip
    device = clip.params["text_model"]["embeddings"]["token_embedding"]["weight"].device
    clip_ids = torch.as_tensor(clip.tokenizer(prompts), dtype=torch.long, device=device)
    pooled = clip_text.apply(clip.params, clip_ids, clip.config)["pooler_output"]
    if t5_ids is None:
        t5_ids = models.t5_tokenizer(prompts, max_length=max_t5_len)
    t5_device = models.t5_params["shared"]["weight"].device
    t5_embeds = t5.apply(models.t5_params,
                         torch.as_tensor(t5_ids, dtype=torch.long, device=t5_device),
                         models.t5_config)
    return pooled, t5_embeds


def make_flux_sampling_fn(cfg: flux.FluxConfig, sampler: FlowMatchSampler, *, latent_hw: int,
                          compute_dtype=torch.bfloat16, mesh=None, num_microbatches: int = 1):
    """Build

        fn(params, packed_latents, pooled, t5_embeds, lora_weights,
           slider_scale, skip_till, guidance) -> packed latents after all steps

    - `lora_weights`: a solo or per-row stacked LoRA tree, or None;
    - `slider_scale`: a (B,) tensor, or a scalar: with a stacked tree the
      branch at that multiplier, with a solo tree the merged-delta path,
      which needs a scalar `skip_till`;
    - `skip_till`, `guidance`: (B,) tensors or scalars. Row b's slider is on
      while step i > skip_till[b] (-1 keeps it on throughout).
    Everything runs on the latents' device under torch.inference_mode()."""
    if mesh is not None or num_microbatches != 1:
        raise NotImplementedError(
            "pipeline-parallel FLUX sampling is not ported yet (ROADMAP queue 1, item 15)")
    img_ids_arr = torch.as_tensor(flux.image_ids(latent_hw, latent_hw))

    @torch.inference_mode()
    def fn(params, latents, pooled, t5_embeds, lora_weights, slider_scale, skip_till, guidance):
        device = latents.device
        x = latents.to(compute_dtype)
        B = x.shape[0]
        tids = torch.as_tensor(flux.text_ids(t5_embeds.shape[1]))
        g = None
        if cfg.guidance_embeds:
            g = torch.as_tensor(guidance, dtype=torch.float32, device=device).expand(B)
        merge, merged = False, None  # W + delta, built at the first gated step
        if lora_weights is not None:
            slider_scale = torch.as_tensor(slider_scale, dtype=torch.float32, device=device)
            skip_till = torch.as_tensor(skip_till, dtype=torch.float32, device=device)
            merge = slider_scale.ndim == 0 and not is_stacked(lora_weights)
            if merge and skip_till.ndim > 0:
                raise ValueError("a scalar slider scale (the merged-delta path) needs a "
                                 "scalar skip_till")
            gate_from = float(skip_till) if merge else None
        pooled = pooled.to(device=device, dtype=compute_dtype)
        t5_embeds = t5_embeds.to(device=device, dtype=compute_dtype)
        timesteps = sampler.timesteps.to(device)
        for i in range(sampler.num_steps):
            t_norm = (timesteps[i] / 1000.0).expand(B)
            p, lora = params, None
            if merge:
                # gate = (i > skip_till) is 0 or 1: W or W + delta
                if i > gate_from:
                    if merged is None:
                        merged = merge_lora_weights(params, lora_weights, slider_scale)
                    p = merged
            elif lora_weights is not None:
                gated = slider_scale * torch.where(skip_till < i, 1.0, 0.0)
                lora = SliderLora(weights=lora_weights, multiplier=gated)
            v = flux.apply(p, cfg, x, t_norm, pooled, t5_embeds, tids, img_ids_arr,
                           guidance=g, lora=lora)
            x = sampler.step(i, v, x).to(compute_dtype)
        return x

    return fn


def initial_packed_latents(generator: torch.Generator, batch: int, height: int, width: int,
                           latent_channels: int = 16) -> torch.Tensor:
    """Unit-normal packed latents for a height x width pixel canvas, drawn on
    the generator's device."""
    noise = torch.randn((batch, height // 8, width // 8, latent_channels), generator=generator,
                        device=generator.device)
    return flux.pack_latents(noise)

