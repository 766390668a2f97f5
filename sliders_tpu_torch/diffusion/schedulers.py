"""Diffusion noise schedules, the DDIM sampler and FlowMatch-Euler
(port of the DDIM and FlowMatch paths of sliders_tpu/diffusion/schedulers.py).

`make_schedule` builds the 1000-step training tables (scaled_linear betas,
0.00085 -> 0.012). `make_sampler(schedule, "ddim", n)` precomputes every
per-step quantity with numpy ("leading" spacing, set_alpha_to_one=True, as
the diffusers defaults the reference relies on); `Sampler.step(i, ...)` is
indexed by step POSITION (0 = most noisy), and `i` may be an int or a (B,)
tensor of per-row positions.

Coefficients are cast to the latents' dtype before use, as the JAX package's
`_bcast` does, so a bf16 denoise rounds at the same points.

`make_flowmatch_sampler` builds FLUX's FlowMatch-Euler tables (the
resolution-dependent mu shift, custom_flux_pipeline.py:67-137) in f64 numpy,
stored as f32. DDPM, LMS and Euler-ancestral come with ROADMAP queue 1,
item 4.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class DiffusionSchedule:
    betas: torch.Tensor  # (T,) f32
    alphas_cumprod: torch.Tensor  # (T,) f32
    num_train_timesteps: int = 1000
    prediction_type: str = "epsilon"

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
        """q(x_t | x_0): sqrt(acp_t) x0 + sqrt(1 - acp_t) noise, at the
        integer timestep `t` (an int or a (B,) tensor of per-row ones)."""
        acp = _bcast(self.alphas_cumprod[torch.as_tensor(t, dtype=torch.long)], x0)
        return torch.sqrt(acp) * x0 + torch.sqrt(1.0 - acp) * noise


def _bcast(v, like: torch.Tensor) -> torch.Tensor:
    """Cast to like.dtype and right-pad dims so a per-row value broadcasts."""
    v = torch.as_tensor(v).to(device=like.device, dtype=like.dtype)
    return v.reshape(v.shape + (1,) * (like.ndim - v.ndim))


def make_betas(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "scaled_linear",
) -> np.ndarray:
    if beta_schedule == "scaled_linear":
        return np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                           dtype=np.float64) ** 2
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    raise ValueError(f"unknown beta_schedule {beta_schedule}")


def make_schedule(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "scaled_linear",
    prediction_type: str = "epsilon",
) -> DiffusionSchedule:
    betas = make_betas(num_train_timesteps, beta_start, beta_end, beta_schedule)
    acp = np.cumprod(1.0 - betas)
    return DiffusionSchedule(
        betas=torch.as_tensor(betas, dtype=torch.float32),
        alphas_cumprod=torch.as_tensor(acp, dtype=torch.float32),
        num_train_timesteps=num_train_timesteps,
        prediction_type=prediction_type,
    )


@dataclass(frozen=True)
class Sampler:
    """Precomputed DDIM plan for `num_steps` steps (tables on the CPU, f32)."""

    kind: str
    schedule: DiffusionSchedule
    timesteps: torch.Tensor  # (n,) value fed to the model
    init_noise_sigma: float
    alpha_prod: torch.Tensor  # (n,) alpha_cumprod at t
    alpha_prod_prev: torch.Tensor  # (n,) alpha_cumprod at the previous grid point

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]

    def scale_model_input(self, x: torch.Tensor, i) -> torch.Tensor:
        return x  # identity for DDIM

    def init_state(self, x: torch.Tensor) -> dict:
        return {}

    def step(self, i, model_out: torch.Tensor, x: torch.Tensor, state: dict):
        """x_t -> x_{t-1} (diffusers DDIMScheduler.step, eta=0,
        clip_sample=False). Returns (x, state)."""
        i = torch.as_tensor(i)
        acp = _bcast(self.alpha_prod[i], x)
        sq_a, sq_1ma = torch.sqrt(acp), torch.sqrt(1.0 - acp)
        if self.schedule.prediction_type == "epsilon":
            eps = model_out
            x0 = (x - sq_1ma * eps) / sq_a
        else:  # v_prediction
            x0 = sq_a * x - sq_1ma * model_out
            eps = sq_a * model_out + sq_1ma * x
        acp_prev = _bcast(self.alpha_prod_prev[i], x)
        return torch.sqrt(acp_prev) * x0 + torch.sqrt(1.0 - acp_prev) * eps, state


def _leading_timesteps(T: int, n: int) -> np.ndarray:
    step_ratio = T // n
    return (np.arange(0, n) * step_ratio).round()[::-1].copy().astype(np.int64)


def make_sampler(schedule: DiffusionSchedule, kind: str = "ddim", num_steps: int = 50) -> Sampler:
    if kind in ("ddpm", "lms", "euler_a"):
        raise NotImplementedError(
            f"the {kind!r} sampler is not ported yet (ROADMAP queue 1, item 4)"
        )
    if kind != "ddim":
        raise ValueError(f"Unknown scheduler name: {kind}")
    T = schedule.num_train_timesteps
    acp = schedule.alphas_cumprod.double().numpy()
    ts = _leading_timesteps(T, num_steps)
    prev_ts = ts - T // num_steps
    # set_alpha_to_one=True -> the final alpha is exactly 1.0
    alpha_prod_prev = np.where(prev_ts >= 0, acp[np.clip(prev_ts, 0, T - 1)], 1.0)
    return Sampler(
        kind=kind,
        schedule=schedule,
        timesteps=torch.as_tensor(ts, dtype=torch.float32),
        init_noise_sigma=1.0,
        alpha_prod=torch.as_tensor(acp[ts], dtype=torch.float32),
        alpha_prod_prev=torch.as_tensor(alpha_prod_prev, dtype=torch.float32),
    )


@dataclass(frozen=True)
class FlowMatchSampler:
    """FlowMatch-Euler plan (FLUX): tables on the CPU, f32."""

    timesteps: torch.Tensor  # (n,) in [0, 1000)
    sigmas: torch.Tensor  # (n + 1,)

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]

    def step(self, i, model_out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """x + (sigma_{i+1} - sigma_i) * v; dt is cast to x's dtype."""
        i = torch.as_tensor(i)
        dt = _bcast(self.sigmas[i + 1] - self.sigmas[i], x)
        return x + dt * model_out

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, i) -> torch.Tensor:
        s = _bcast(self.sigmas[torch.as_tensor(i)], x0)
        return (1.0 - s) * x0 + s * noise


def calculate_shift(image_seq_len: int, base_seq_len: int = 256, max_seq_len: int = 4096,
                    base_shift: float = 0.5, max_shift: float = 1.16) -> float:
    """Resolution-dependent mu (custom_flux_pipeline.py:67-77)."""
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return image_seq_len * m + b


def make_flowmatch_sampler(num_steps: int, image_seq_len: Optional[int] = None,
                           mu: Optional[float] = None, num_train_timesteps: int = 1000,
                           use_dynamic_shifting: bool = True) -> FlowMatchSampler:
    sigmas = np.linspace(1.0, 1.0 / num_steps, num_steps, dtype=np.float64)
    if use_dynamic_shifting:
        if mu is None:
            if image_seq_len is None:
                raise ValueError("need image_seq_len or mu for dynamic shifting")
            mu = calculate_shift(image_seq_len)
        # time_shift: exp(mu) / (exp(mu) + (1/s - 1))
        sigmas = np.exp(mu) / (np.exp(mu) + (1.0 / sigmas - 1.0))
    timesteps = sigmas * num_train_timesteps
    sigmas = np.concatenate([sigmas, [0.0]])
    return FlowMatchSampler(timesteps=torch.as_tensor(timesteps, dtype=torch.float32),
                            sigmas=torch.as_tensor(sigmas, dtype=torch.float32))
