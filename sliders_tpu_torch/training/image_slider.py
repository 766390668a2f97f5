"""Image-slider training step (port of sliders_tpu/training/image_slider.py).

Reference semantics (trainscripts/imagesliders/train_lora-scale.py:180-335),
per iteration:
  1. a scale s and one filename, read from the -s and +s folders (the
     driver, `data/paired_images.py`);
  2. VAE-encode both images in f32; add the SAME noise at the t_to grid
     timestep (get_noisy_image, imagesliders/train_util.py:199-235);
  3. with the slider at +s, eps for the "high" image under the positive
     prompt; with the slider at -s, eps for the "low" image under the
     neutral prompt; each against the added noise;
  4. one optimizer update on the sum of the two MSEs.

As in the JAX package, the two passes of step 3 are ONE batch-2B UNet call
with the per-row LoRA multiplier [+s] * B + [-s] * B (`ops/basic.SliderLora`),
the reference's two dead frozen predictions are skipped, and its timestep
quirk is kept: the noise goes in at the 50-grid timestep
`sampler.timesteps[t_to]`, truncated to an integer (lms and euler_a's
linspace timesteps are floats), the UNet predicts at the 1000-grid timestep
`ts1000[t_to * T / max_steps]` on the input scaled by `scale1000` there. The
step never calls `sampler.step`, so every sampler kind runs it.

The step runs eagerly (`torch.autograd.grad` of the loss with respect to
the LoRA leaves). Its draws (t_to in [1, max_steps - 1), the posterior eps
of each of the 2B images, one noise tensor shared by the two halves) come
from `text_slider.draw_generator(seed, step)` on the CPU, so a device and a
rerun draw the same; a parity test passes the JAX package's in as `draws`.

Not ported (each raises when asked for): `chunk > 1` (ROADMAP queue 1,
item 18) and a device mesh (item 15).
"""

from __future__ import annotations

import torch

from sliders_tpu_torch.diffusion.guidance import train_grid_tables
from sliders_tpu_torch.diffusion.schedulers import DiffusionSchedule, Sampler
from sliders_tpu_torch.models import unet2d, vae
from sliders_tpu_torch.ops.basic import SliderLora
from sliders_tpu_torch.training.optimizers import SliderOptimizer
from sliders_tpu_torch.training.text_slider import (
    SliderTrainState,
    _PhaseTimer,
    backward_and_update,
    draw_generator,
    lora_leaves,
)


def image_step_draws(seed: int, step: int, max_denoising_steps: int, latent_shape: tuple):
    """(t_to, posterior eps (2B, h, w, c), noise (B, h, w, c)) of iteration
    `step` for (B, h, w, c) latents, all from `draw_generator(seed, step)`."""
    gen = draw_generator(seed, step)
    b, h, w, c = latent_shape
    t_to = int(torch.randint(1, max_denoising_steps - 1, (1,), generator=gen))
    eps = torch.randn((2 * b, h, w, c), generator=gen)
    noise = torch.randn((b, h, w, c), generator=gen)
    return t_to, eps, noise


def make_image_slider_step(
    unet_cfg: unet2d.UNetConfig,
    vae_cfg: vae.VaeConfig,
    schedule: DiffusionSchedule,
    sampler: Sampler,
    optimizer: SliderOptimizer,
    *,
    max_denoising_steps: int = 50,
    compute_dtype=torch.bfloat16,
    remat: bool = True,
    is_xl: bool = False,
    mesh=None,
    chunk: int = 1,
):
    """Build `step(state, unet_params, vae_params, batch, draws=None) ->
    (state, metrics)`.

    `batch` holds, on the UNet's device: images_low / images_high (B, H, W,
    3) uint8, normalised here by x / 127.5 - 1 (or float in [-1, 1]);
    scale, the iteration's s > 0; positive / neutral (L, D) embeddings; for
    SDXL pooled_positive / pooled_neutral and time_ids (6,). `draws`, if
    given, is (t_to, posterior eps, noise) in place of `image_step_draws`.
    The step updates `state` in place (LoRA, optimizer state, step + 1) and
    returns it with the metrics loss, t_to, scale, grad_norm (Python
    numbers) and, on CUDA, phase_ms: the device time of the encode (with the
    noising), the grad pass (forward and backward) and the update."""
    if chunk != 1:
        raise NotImplementedError("the chunk > 1 step variant is not ported yet "
                                  "(ROADMAP queue 1, item 18)")
    if mesh is not None:
        raise NotImplementedError("a device mesh is not ported yet (ROADMAP queue 1, item 15)")
    ts1000, scale1000 = train_grid_tables(schedule, sampler.kind)
    grid_stride = schedule.num_train_timesteps // max_denoising_steps

    def step(state: SliderTrainState, unet_params: dict, vae_params: dict, batch: dict,
             draws=None):
        device = batch["positive"].device
        B = batch["images_high"].shape[0]
        timer = _PhaseTimer(device)
        timer.mark("start")

        with torch.no_grad():
            # both sides in one batch-2B f32 encode; the posterior eps is
            # drawn per image, the added noise once for both halves
            imgs = torch.cat([batch["images_high"], batch["images_low"]]).to(device)
            if imgs.dtype == torch.uint8:
                imgs = imgs.float() / 127.5 - 1.0
            mean, logvar = vae.encode(vae_params, vae_cfg, imgs.float())
            if draws is None:
                draws = image_step_draws(state.seed, state.step, max_denoising_steps,
                                         (B, *mean.shape[1:]))
            t_to, eps_post, noise1 = draws
            t_to = int(t_to)
            if not 1 <= t_to < max_denoising_steps - 1:
                raise ValueError(f"t_to {t_to} out of [1, {max_denoising_steps - 1})")
            lat = vae.normalize_latents(vae_cfg, vae.sample_latents(mean, logvar, eps=eps_post))
            noise1 = torch.as_tensor(noise1).to(device=device, dtype=lat.dtype)
            noise = torch.cat([noise1, noise1])
            # the 50-grid value (the reference's quirk), truncated as
            # astype(int32) truncates it
            t_add = int(sampler.timesteps[t_to])
            noisy = schedule.add_noise(lat, noise, t_add)
            t_idx = t_to * grid_stride
            t_cur = ts1000[t_idx].to(device)
            x_in = (noisy * scale1000[t_idx].to(device)).to(compute_dtype)

            def rep(e):
                return e.expand(B, *e.shape).to(compute_dtype)

            ehs = torch.cat([rep(batch["positive"]), rep(batch["neutral"])])
            added = None
            if is_xl:
                added = {"text_embeds": torch.cat([rep(batch["pooled_positive"]),
                                                   rep(batch["pooled_neutral"])]),
                         "time_ids": rep(batch["time_ids"]).repeat(2, 1)}
            s = torch.as_tensor(batch["scale"], dtype=torch.float32)
            mult = torch.cat([torch.full((B,), 1.0), torch.full((B,), -1.0)]) * s
            timer.mark("encode")

        leaves = lora_leaves(state.lora)
        eps = unet2d.apply(unet_params, unet_cfg, x_in, t_cur, ehs, added_cond=added,
                           lora=SliderLora(weights=leaves, multiplier=mult.to(device)),
                           remat=remat).float()
        diff = eps - noise
        # the sum of the two sides' MSEs (the reference accumulates both
        # backwards before one optimizer step)
        loss = 2.0 * torch.mean(diff * diff)
        grad_norm = backward_and_update(state, optimizer, loss, leaves, timer)
        metrics = {"loss": loss.item(), "t_to": t_to, "scale": float(s),
                   "grad_norm": grad_norm.item(), "phase_ms": timer.phase_ms()}
        return state, metrics

    return step
