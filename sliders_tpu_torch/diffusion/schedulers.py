"""Diffusion noise schedules, the DDIM / DDPM / LMS / Euler-ancestral
samplers and FlowMatch-Euler (port of sliders_tpu/diffusion/schedulers.py).

`make_schedule` builds the 1000-step training tables (scaled_linear betas,
0.00085 -> 0.012). `make_sampler(schedule, kind, n)` precomputes every
per-step quantity with numpy in f64 and stores it as f32, as the diffusers
defaults the reference relies on give them: "leading" spacing for DDIM and
DDPM (set_alpha_to_one=True), "linspace" for LMS and Euler-ancestral, whose
`init_noise_sigma` is sigmas.max() (about 14.6 at 50 steps, not 1). The LMS
Adams-Bashforth coefficients are integrated exactly (a Lagrange basis of
degree <= 3), four deep, zero-padded during the warm-up.

`Sampler.step(i, ...)` is indexed by step POSITION (0 = most noisy), and
`i` may be an int or a (B,) tensor of per-row positions for every kind.
The tables live on the CPU; `Sampler.to(device)` gives a copy whose tables
live on the device, so that per-row positions held there index them with
no host sync (the continuous step function's chunks).
Coefficients are cast to the latents' dtype before use, as the JAX
package's `_bcast` does, so a bf16 denoise rounds at the same points; but
DDPM forms its posterior coefficients in f32 first (the JAX step's bf16
last step is 0 / 0, see `_ddpm_step`). The
ancestral samplers (ddpm, euler_a) take their noise as a given tensor or
draw it from a `torch.Generator`; they raise if given neither.

`make_flowmatch_sampler` builds FLUX's FlowMatch-Euler tables (the
resolution-dependent mu shift, custom_flux_pipeline.py:67-137) in f64 numpy,
stored as f32.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Optional

import numpy as np
import torch

STOCHASTIC_KINDS = ("ddpm", "euler_a")
LMS_ORDER = 4


@dataclass(frozen=True)
class DiffusionSchedule:
    betas: torch.Tensor  # (T,) f32
    alphas_cumprod: torch.Tensor  # (T,) f32
    num_train_timesteps: int = 1000
    prediction_type: str = "epsilon"

    def _acp(self, t, like: torch.Tensor) -> torch.Tensor:
        return _bcast(self.alphas_cumprod[torch.as_tensor(t, dtype=torch.long).cpu()], like)

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
        """q(x_t | x_0): sqrt(acp_t) x0 + sqrt(1 - acp_t) noise, at the
        integer timestep `t` (an int or a (B,) tensor of per-row ones)."""
        acp = self._acp(t, x0)
        return torch.sqrt(acp) * x0 + torch.sqrt(1.0 - acp) * noise

    def velocity(self, x0: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
        """The v-prediction target sqrt(acp_t) noise - sqrt(1 - acp_t) x0."""
        acp = self._acp(t, x0)
        return torch.sqrt(acp) * noise - torch.sqrt(1.0 - acp) * x0

    def to_eps_x0(self, model_out: torch.Tensor, t, x_t: torch.Tensor):
        """A model output under `prediction_type` -> (eps, x0)."""
        acp = self._acp(t, x_t)
        return _eps_x0(self.prediction_type, torch.sqrt(acp), torch.sqrt(1.0 - acp),
                       model_out, x_t)


def _bcast(v, like: torch.Tensor) -> torch.Tensor:
    """Cast to like.dtype and right-pad dims so a per-row value broadcasts."""
    v = torch.as_tensor(v).to(device=like.device, dtype=like.dtype)
    return v.reshape(v.shape + (1,) * (like.ndim - v.ndim))


def _eps_x0(prediction_type: str, sq_a, sq_1ma, model_out, x):
    if prediction_type == "epsilon":
        return model_out, (x - sq_1ma * model_out) / sq_a
    if prediction_type == "v_prediction":
        return sq_a * model_out + sq_1ma * x, sq_a * x - sq_1ma * model_out
    raise ValueError(f"unknown prediction_type {prediction_type}")


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


def _f32(a) -> Optional[torch.Tensor]:
    return None if a is None else torch.as_tensor(np.asarray(a), dtype=torch.float32)


@dataclass(frozen=True)
class Sampler:
    """Precomputed plan for `num_steps` steps (tables on the CPU, f32). The
    alpha-based kinds (ddim, ddpm) fill alpha_prod / alpha_prod_prev (and
    ddpm_variance); the sigma-based kinds (lms, euler_a) fill sigmas, with
    a final 0 (and lms_coeffs)."""

    kind: str
    schedule: DiffusionSchedule
    timesteps: torch.Tensor  # (n,) value fed to the model
    init_noise_sigma: float
    alpha_prod: Optional[torch.Tensor] = None  # (n,) alpha_cumprod at t
    alpha_prod_prev: Optional[torch.Tensor] = None  # (n,) at the previous grid point
    ddpm_variance: Optional[torch.Tensor] = None  # (n,)
    sigmas: Optional[torch.Tensor] = None  # (n + 1,)
    lms_coeffs: Optional[torch.Tensor] = None  # (n, LMS_ORDER)

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]

    @property
    def stochastic(self) -> bool:
        return self.kind in STOCHASTIC_KINDS

    def to(self, device) -> "Sampler":
        """A copy whose tables live on `device` (the schedule's stay)."""
        return replace(self, **{f.name: getattr(self, f.name).to(device) for f in fields(self)
                                if isinstance(getattr(self, f.name), torch.Tensor)})

    def scale_model_input(self, x: torch.Tensor, i) -> torch.Tensor:
        """x / sqrt(sigma_i^2 + 1) for lms and euler_a; the identity else."""
        if self.kind in ("lms", "euler_a"):
            sigma = self.sigmas[_index(i, self.timesteps.device)]
            return x / _bcast(torch.sqrt(sigma**2 + 1.0), x)
        return x

    def init_state(self, x: torch.Tensor) -> dict:
        """The sampler's carry: LMS's derivative history, newest first."""
        if self.kind == "lms":
            return {"derivs": torch.zeros((LMS_ORDER,) + tuple(x.shape), dtype=x.dtype,
                                          device=x.device)}
        return {}

    def step(self, i, model_out: torch.Tensor, x: torch.Tensor, state: dict,
             generator: Optional[torch.Generator] = None, noise=None):
        """x_t -> x_{t-1}; returns (x, state). The ancestral kinds add
        `noise` (cast to x's dtype) or, without it, a unit-normal draw of
        x's shape from `generator` (on the generator's device)."""
        i = _index(i, self.timesteps.device)
        if self.kind == "ddim":
            return self._ddim_step(i, model_out, x), state
        if self.kind == "lms":
            return self._lms_step(i, model_out, x, state)
        if self.kind not in STOCHASTIC_KINDS:
            raise ValueError(f"unknown sampler kind {self.kind}")
        if noise is None:
            if generator is None:
                raise ValueError(f"the {self.kind} step needs a generator or noise")
            noise = torch.randn(x.shape, generator=generator, device=generator.device)
        noise = torch.as_tensor(noise).to(device=x.device, dtype=x.dtype)
        if self.kind == "ddpm":
            return self._ddpm_step(i, model_out, x, noise), state
        return self._euler_a_step(i, model_out, x, noise), state

    def _pred_eps_x0_alpha(self, i, model_out, x):
        acp = _bcast(self.alpha_prod[i], x)
        return _eps_x0(self.schedule.prediction_type, torch.sqrt(acp), torch.sqrt(1.0 - acp),
                       model_out, x)

    def _ddim_step(self, i, model_out, x):
        # diffusers DDIMScheduler.step, eta=0, clip_sample=False
        eps, x0 = self._pred_eps_x0_alpha(i, model_out, x)
        acp_prev = _bcast(self.alpha_prod_prev[i], x)
        return torch.sqrt(acp_prev) * x0 + torch.sqrt(1.0 - acp_prev) * eps

    def _ddpm_step(self, i, model_out, x, noise):
        # diffusers DDPMScheduler.step, variance_type="fixed_small"; the step
        # at timestep 0 adds no noise. The posterior coefficients are formed
        # from the f32 tables and then cast to x's dtype (the JAX package casts
        # alpha_prod first: in bf16 acp at timestep 0, 0.99915, rounds to 1
        # and its last step is 0 / 0); in f32 the two are the same numbers.
        _, x0 = self._pred_eps_x0_alpha(i, model_out, x)
        acp, acp_prev = self.alpha_prod[i], self.alpha_prod_prev[i]
        alpha_t = acp / acp_prev
        beta_t = 1.0 - alpha_t
        coef_x0 = _bcast(torch.sqrt(acp_prev) * beta_t / (1.0 - acp), x)
        coef_xt = _bcast(torch.sqrt(alpha_t) * (1.0 - acp_prev) / (1.0 - acp), x)
        std = torch.where(self.timesteps[i] <= 0, 0.0, torch.sqrt(self.ddpm_variance[i]))
        return coef_x0 * x0 + coef_xt * x + _bcast(std, x) * noise

    def _sigma_eps_x0(self, i, model_out, x):
        """(derivative, x0) in sigma space."""
        sigma = _bcast(self.sigmas[i], x)
        if self.schedule.prediction_type == "epsilon":
            x0 = x - sigma * model_out
        else:  # v_prediction: diffusers' sigma-space conversion
            x0 = model_out * (-sigma / torch.sqrt(sigma**2 + 1)) + (x / (sigma**2 + 1))
        return (x - x0) / sigma, x0

    def _euler_a_step(self, i, model_out, x, noise):
        sigma_from = _bcast(self.sigmas[i], x)
        sigma_to = _bcast(self.sigmas[i + 1], x)
        deriv, _ = self._sigma_eps_x0(i, model_out, x)
        sigma_up2 = sigma_to**2 * (sigma_from**2 - sigma_to**2) / sigma_from**2
        sigma_up = torch.sqrt(sigma_up2)
        sigma_down = torch.sqrt(sigma_to**2 - sigma_up2)
        x = x + deriv * (sigma_down - sigma_from)
        return x + noise * sigma_up

    def _lms_step(self, i, model_out, x, state):
        deriv, _ = self._sigma_eps_x0(i, model_out, x)
        derivs = torch.cat([deriv[None], state["derivs"][:-1]])  # [0] = newest
        # the coefficients are rounded to x's dtype, then promoted with the
        # history (f32 once a guidance vector made eps f32), as JAX promotes
        coeffs = self.lms_coeffs[i].to(device=x.device, dtype=x.dtype)
        coeffs = coeffs.to(torch.promote_types(coeffs.dtype, derivs.dtype))
        derivs = derivs.to(coeffs.dtype)
        if coeffs.ndim == 1:  # one step position: (LMS_ORDER,), zero-padded in the warm-up
            upd = torch.tensordot(coeffs, derivs, dims=1)
        else:  # per-row positions: (B, LMS_ORDER) coefficient rows
            upd = torch.einsum("bo,ob...->b...", coeffs, derivs)
        return x + upd, {"derivs": derivs}

    def ddim_inverse_step(self, i, model_out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The exact inverse of the DDIM step `i`: moves x from the noise
        level of alpha_prod_prev[i] up to alpha_prod[i]; running i = n-1 ..
        0 inverts a clean latent to x_T (the null-text inversion notebook's
        `next_step`)."""
        i = _index(i, self.timesteps.device)
        acp_from = _bcast(self.alpha_prod_prev[i], x)
        acp_to = _bcast(self.alpha_prod[i], x)
        eps, x0 = _eps_x0(self.schedule.prediction_type, torch.sqrt(acp_from),
                          torch.sqrt(1.0 - acp_from), model_out, x)
        return torch.sqrt(acp_to) * x0 + torch.sqrt(1.0 - acp_to) * eps


def _index(i, device="cpu") -> torch.Tensor:
    """A step position (an int or a (B,) tensor) as an index of tables on
    `device`."""
    return torch.as_tensor(i, dtype=torch.long).to(device)


def _leading_timesteps(T: int, n: int) -> np.ndarray:
    step_ratio = T // n
    return (np.arange(0, n) * step_ratio).round()[::-1].copy().astype(np.int64)


def _linspace_timesteps(T: int, n: int) -> np.ndarray:
    return np.linspace(0, T - 1, n, dtype=np.float64)[::-1].copy()


def _lms_coefficients(sigmas: np.ndarray, order: int = LMS_ORDER) -> np.ndarray:
    """Exact Adams-Bashforth coefficients on the sigma grid:

    coeff[i, j] = int_{sigma_i}^{sigma_{i+1}} prod_{k != j, k < ord_i}
                  (s - c_k) / (c_j - c_k) ds

    with c_m = sigmas[i - m] and ord_i = min(i + 1, order)."""
    n = len(sigmas) - 1
    out = np.zeros((n, order))
    for i in range(n):
        ord_i = min(i + 1, order)
        for j in range(ord_i):
            ck = [sigmas[i - k] for k in range(ord_i) if k != j]
            num = np.poly(ck) if ck else np.array([1.0])  # roots -> coefficients
            den = np.prod([sigmas[i - j] - c for c in ck]) if ck else 1.0
            integ = np.polyint(num / den)
            out[i, j] = np.polyval(integ, sigmas[i + 1]) - np.polyval(integ, sigmas[i])
    return out


def make_sampler(schedule: DiffusionSchedule, kind: str = "ddim", num_steps: int = 50) -> Sampler:
    T = schedule.num_train_timesteps
    acp = schedule.alphas_cumprod.double().numpy()

    if kind in ("ddim", "ddpm"):
        ts = _leading_timesteps(T, num_steps)
        prev_ts = ts - T // num_steps
        alpha_prod = acp[ts]
        # set_alpha_to_one=True -> the final alpha is exactly 1.0
        alpha_prod_prev = np.where(prev_ts >= 0, acp[np.clip(prev_ts, 0, T - 1)], 1.0)
        ddpm_var = None
        if kind == "ddpm":
            alpha_t = alpha_prod / alpha_prod_prev
            var = (1.0 - alpha_prod_prev) / (1.0 - alpha_prod) * (1.0 - alpha_t)
            ddpm_var = np.clip(var, 1e-20, None)
        return Sampler(kind=kind, schedule=schedule, timesteps=_f32(ts), init_noise_sigma=1.0,
                       alpha_prod=_f32(alpha_prod), alpha_prod_prev=_f32(alpha_prod_prev),
                       ddpm_variance=_f32(ddpm_var))

    if kind in ("lms", "euler_a"):
        ts = _linspace_timesteps(T, num_steps)
        train_sigmas = np.sqrt((1.0 - acp) / acp)
        sigmas = np.concatenate([np.interp(ts, np.arange(T), train_sigmas), [0.0]])
        return Sampler(kind=kind, schedule=schedule, timesteps=_f32(ts),
                       # "linspace" spacing -> init_noise_sigma = sigmas.max(), in f32
                       init_noise_sigma=float(np.float32(sigmas.max())),
                       sigmas=_f32(sigmas),
                       lms_coeffs=_f32(_lms_coefficients(sigmas)) if kind == "lms" else None)

    raise ValueError(f"Unknown scheduler name: {kind}")


def sigma_add_noise(sampler: Sampler, x0: torch.Tensor, noise: torch.Tensor, i) -> torch.Tensor:
    """add_noise of the sigma-based samplers: x0 + sigma_i * noise."""
    return x0 + _bcast(sampler.sigmas[_index(i, sampler.sigmas.device)], x0) * noise


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
