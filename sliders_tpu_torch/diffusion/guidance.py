"""Classifier-free guidance (port of sliders_tpu/diffusion/guidance.py).

`cfg_combine` is the reference predict_noise guidance arithmetic
(train_util.py:145-171) over a batch-doubled forward; `rescale_noise_cfg`
reproduces train_util.py:199-217. `train_grid_tables` gives, for the
1000-step training grid the reference builds with `set_timesteps(1000)`
(train_lora.py:209-213), the timestep value and model-input scale at each
grid index, so the train step's jump onto that grid is a table lookup.
"""

from __future__ import annotations

import numpy as np
import torch

from sliders_tpu_torch.diffusion.schedulers import DiffusionSchedule


def cfg_combine(eps: torch.Tensor, guidance_scale) -> torch.Tensor:
    """eps is the batch-doubled output [uncond..., cond...]; `guidance_scale`
    is a scalar or a per-row (B,) tensor."""
    eps_u, eps_c = eps.chunk(2, dim=0)
    if isinstance(guidance_scale, torch.Tensor) and guidance_scale.ndim > 0:
        guidance_scale = guidance_scale.to(eps.device).reshape((-1,) + (1,) * (eps_u.ndim - 1))
    return eps_u + guidance_scale * (eps_c - eps_u)


def rescale_noise_cfg(noise_cfg: torch.Tensor, noise_pred_text: torch.Tensor,
                      guidance_rescale: float = 0.0) -> torch.Tensor:
    """Guidance rescale (arXiv 2305.08891 section 3.4)."""
    dims = tuple(range(1, noise_pred_text.ndim))
    std_text = noise_pred_text.std(dim=dims, keepdim=True, correction=0)
    std_cfg = noise_cfg.std(dim=dims, keepdim=True, correction=0)
    rescaled = noise_cfg * (std_text / std_cfg)
    return guidance_rescale * rescaled + (1 - guidance_rescale) * noise_cfg


def train_grid_tables(schedule: DiffusionSchedule, kind: str):
    """(timestep value, model-input scale) per index of the 1000-step grid,
    both (T,) f32 on the CPU. The values are computed in f64 and rounded
    once, as the JAX package does, so ts1000[t_to * 1000 / steps] is exact."""
    T = schedule.num_train_timesteps
    ts = np.arange(T - 1, -1, -1, dtype=np.float64)  # [999, ..., 0]
    if kind in ("lms", "euler_a"):
        acp = schedule.alphas_cumprod.double().numpy()
        sigmas = np.sqrt((1 - acp) / acp)[ts.astype(int)]
        scale = 1.0 / np.sqrt(sigmas**2 + 1.0)
    else:
        scale = np.ones_like(ts)
    return (torch.as_tensor(ts.astype(np.float32)), torch.as_tensor(scale.astype(np.float32)))
