"""Classifier-free guidance (port of sliders_tpu/diffusion/guidance.py).

`cfg_combine` is the reference predict_noise guidance arithmetic
(train_util.py:145-171) over a batch-doubled forward; `rescale_noise_cfg`
reproduces train_util.py:199-217.
"""

from __future__ import annotations

import torch


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
