"""Real-image editing: DDIM inversion, null-text optimisation and slider
re-sampling (port of sliders_tpu/pipelines/inversion.py).

The reference flow (demo_image_editing.ipynb cells 3-10, SURVEY.md §3.5):
  1. DDIM-invert the VAE latent of a real image with conditional-only
     predictions (n reverse `next_step`s);
  2. per timestep, optimise the unconditional embedding with Adam
     (lr 1e-2 (1 - i/100), at most 10 inner steps, stopping after the
     update whose loss passed below eps + i 2e-5) so that the CFG
     trajectory reproduces the recorded inversion trajectory;
  3. re-sample from x_T with the per-step optimised uncond embeddings and
     the slider gated at start_noise (500 in the notebook).

PyTorch runs each loop eagerly. The conditional eps of a timestep is
computed once, under torch.no_grad(), and reused across the inner loop and
the trajectory's advance, as the notebook and the JAX package do; only the
uncond embedding requires a gradient, and the UNet's parameters are frozen.
Adam is written out with optax.adam's defaults (b1 0.9, b2 0.999, eps
1e-8) and order of operations. Each inner step reads its loss on the host
to decide the break: the notebook's semantics.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sliders_tpu_torch.diffusion.schedulers import Sampler
from sliders_tpu_torch.lora.merge import merge_lora_weights
from sliders_tpu_torch.models import unet2d
from sliders_tpu_torch.ops.basic import SliderLora

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def make_ddim_inversion_fn(unet_cfg: unet2d.UNetConfig, sampler: Sampler,
                           compute_dtype=torch.float32):
    """fn(unet_params, clean_latents, cond_emb) -> trajectory (n + 1, B, ...)
    with traj[0] = x_T (the noisiest) and traj[n] = the clean latents."""
    n = sampler.num_steps

    @torch.inference_mode()
    def fn(unet_params, latents, cond_emb):
        latents = latents.to(compute_dtype)
        traj = [latents] * (n + 1)
        x = latents
        for i in range(n - 1, -1, -1):  # adding noise
            eps = unet2d.apply(unet_params, unet_cfg, x, sampler.timesteps[i], cond_emb)
            x = sampler.ddim_inverse_step(i, eps, x).to(compute_dtype)
            traj[i] = x
        return torch.stack(traj)

    return fn


def adam_step(u: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, count: int,
              lr) -> tuple:
    """One optax.adam update of `u` by gradient `g` (its first and second
    moments `m`, `v`; `count` the step number from 1): returns (u, m, v)."""
    m = (1 - ADAM_B1) * g + ADAM_B1 * m
    v = (1 - ADAM_B2) * g * g + ADAM_B2 * v
    m_hat = m / (1 - np.float32(ADAM_B1) ** np.float32(count))
    v_hat = v / (1 - np.float32(ADAM_B2) ** np.float32(count))
    return u + (-lr) * (m_hat / (torch.sqrt(v_hat) + ADAM_EPS)), m, v


def make_null_text_optimizer(unet_cfg: unet2d.UNetConfig, sampler: Sampler, *,
                             guidance_scale: float = 7.5, num_inner_steps: int = 10,
                             base_lr: float = 1e-2, epsilon: float = 1e-5,
                             compute_dtype=torch.float32, on_step=None):
    """fn(unet_params, traj, cond_emb, uncond_emb) -> (n, B, L, D) per-step
    optimised uncond embeddings. Each step starts a fresh Adam from
    `uncond_emb`, as the JAX package does; `on_step(i, losses)`, if given,
    receives each step's inner losses (host floats)."""
    n = sampler.num_steps

    def fn(unet_params, traj, cond_emb, uncond_emb):
        traj = traj.clone()  # an inference-mode trajectory enters the graphs as a constant
        x = traj[0].to(compute_dtype)
        out = []
        for i in range(n):
            t = sampler.timesteps[i]
            target = traj[i + 1]
            lr = np.float32(base_lr) * (np.float32(1.0) - np.float32(i) / np.float32(100.0))
            threshold = np.float32(epsilon) + np.float32(i) * np.float32(2e-5)
            with torch.no_grad():
                eps_c = unet2d.apply(unet_params, unet_cfg, x, t, cond_emb)
            u = uncond_emb.detach().clone()
            m, v = torch.zeros_like(u), torch.zeros_like(u)
            losses = []
            for j in range(num_inner_steps):
                with torch.enable_grad():
                    u.requires_grad_(True)
                    eps_u = unet2d.apply(unet_params, unet_cfg, x, t, u)
                    eps = eps_u + guidance_scale * (eps_c - eps_u)
                    x_prev, _ = sampler.step(i, eps, x, {})
                    d = (x_prev - target).float()
                    loss = torch.mean(d * d)
                    (g,) = torch.autograd.grad(loss, u)
                with torch.no_grad():
                    u, m, v = adam_step(u.detach(), g, m, v, j + 1, float(lr))
                losses.append(float(loss.detach()))
                if losses[-1] < threshold:  # the notebook's break, after the update
                    break
            if on_step is not None:
                on_step(i, losses)
            with torch.no_grad():
                eps_u = unet2d.apply(unet_params, unet_cfg, x, t, u)
                x, _ = sampler.step(i, eps_u + guidance_scale * (eps_c - eps_u), x, {})
                x = x.to(compute_dtype)
            out.append(u)
        return torch.stack(out)

    return fn


def make_edit_sampling_fn(unet_cfg: unet2d.UNetConfig, sampler: Sampler, *,
                          guidance_scale: float = 7.5, compute_dtype=torch.float32):
    """Build fn(unet_params, x_T, cond_emb, uncond_per_step, lora_weights,
    slider_scale, start_noise) -> latents: CFG sampling from x_T with the
    PER-STEP uncond embeddings `uncond_per_step` (n, B, L, D) and the slider
    off while t > start_noise (notebook cell 10: start_noise 500).
    `slider_scale` is a (B,) vector of per-row multipliers (the whole sweep
    of cell 10 as one batched denoise), or a scalar: the merged path, each
    step on W or on W + delta (formed once), the gate being 0 or 1."""
    n = sampler.num_steps

    @torch.inference_mode()
    def fn(unet_params, x_T, cond_emb, uncond_per_step, lora_weights, slider_scale, start_noise):
        vector = lora_weights is not None and torch.as_tensor(slider_scale).ndim == 1
        if vector:
            slider_scale = torch.as_tensor(slider_scale, dtype=torch.float32,
                                           device=x_T.device)
        start_noise = float(start_noise)
        merged = None
        x = x_T.to(compute_dtype)
        state = sampler.init_state(x)
        for i in range(n):
            t = sampler.timesteps[i]
            params, lora = unet_params, None
            if lora_weights is not None and not vector and float(t) <= start_noise:
                if merged is None:
                    merged = merge_lora_weights(unet_params, lora_weights, slider_scale)
                params = merged
            elif vector:
                mult = torch.where(t.to(x.device) > start_noise, 0.0, slider_scale)
                lora = SliderLora(weights=lora_weights, multiplier=torch.cat([mult, mult]))
            ehs = torch.cat([uncond_per_step[i], cond_emb])
            eps = unet2d.apply(params, unet_cfg, torch.cat([x, x]), t, ehs, lora=lora)
            eps_u, eps_c = eps.chunk(2)
            x, state = sampler.step(i, eps_u + guidance_scale * (eps_c - eps_u), x, state)
            x = x.to(compute_dtype)
        return x

    return fn


def edit_image(models, image, prompt: str, slider_weights: Optional[dict], scales=(0.0, 1.0), *,
               num_steps: int = 50, start_noise: float = 500.0, guidance_scale: float = 7.5,
               num_inner_steps: int = 10, on_step=None, timings: Optional[dict] = None) -> dict:
    """The whole editing flow on an SD model (`models`, VAE loaded, f32):
    `image` (H, W, 3) in [-1, 1] is encoded (the posterior mean times the
    scaling factor: the notebook takes the mode), inverted, null-text
    optimised (`on_step` as `make_null_text_optimizer`'s), and the sweep of
    `scales` re-sampled as ONE batched denoise from x_T; returns
    {scale: (H, W, 3) uint8 numpy image}. `timings`, if given, receives the
    seconds of 'encode', 'inversion', 'null_text', 'edit' and 'decode'
    (each ended by a device sync)."""
    import time

    from sliders_tpu_torch.diffusion.schedulers import make_sampler, make_schedule
    from sliders_tpu_torch.models import vae as vae_mod
    from sliders_tpu_torch.pipelines import text2image as t2i
    from sliders_tpu_torch.pipelines.encoding import encode_prompts

    device = models.unet_params["conv_in"]["weight"].device
    clock = {"t": time.perf_counter()}

    def lap(name):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        if timings is not None:
            timings[name] = now - clock["t"]
        clock["t"] = now

    sampler = make_sampler(make_schedule(), "ddim", num_steps)
    te = models.text_encoders[0]
    cond, uncond = (encode_prompts(te.tokenizer, te.params, te.config, [p],
                                   num_layers=te.clip_skip_layers) for p in (prompt, ""))
    with torch.inference_mode():
        img = torch.as_tensor(np.asarray(image, np.float32), device=device)[None]
        mean, _ = vae_mod.encode(models.vae_params, models.vae_config, img)
        lat = mean * models.vae_config.scaling_factor
    lap("encode")
    traj = make_ddim_inversion_fn(models.unet_config, sampler)(models.unet_params, lat, cond)
    lap("inversion")
    null_opt = make_null_text_optimizer(models.unet_config, sampler,
                                        guidance_scale=guidance_scale,
                                        num_inner_steps=num_inner_steps, on_step=on_step)
    uncond_per_step = null_opt(models.unet_params, traj, cond, uncond)
    lap("null_text")
    edit_fn = make_edit_sampling_fn(models.unet_config, sampler, guidance_scale=guidance_scale)
    if slider_weights is None:  # one row serves every scale
        x = edit_fn(models.unet_params, traj[0], cond, uncond_per_step, None, 0.0, start_noise)
        lap("edit")
        img = t2i.decode_images(models.vae_params, models.vae_config, x).cpu().numpy()
        lap("decode")
        return {s: img[0] for s in scales}
    ns = len(scales)
    x = edit_fn(models.unet_params, traj[0].expand(ns, -1, -1, -1), cond.expand(ns, -1, -1),
                uncond_per_step.expand(-1, ns, -1, -1), slider_weights,
                torch.tensor([float(s) for s in scales]), start_noise)
    lap("edit")
    imgs = t2i.decode_images(models.vae_params, models.vae_config, x).cpu().numpy()
    lap("decode")
    return {s: imgs[i] for i, s in enumerate(scales)}
