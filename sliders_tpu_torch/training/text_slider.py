"""Text-slider training step (port of sliders_tpu/training/text_slider.py).

Reference semantics (trainscripts/textsliders/train_lora.py:155-309), per
iteration:
  1. draw a prompt pair and t_to in [1, max_denoising_steps);
  2. from pure noise, denoise t_to steps of the max_denoising_steps grid with
     the slider ON at guidance 3 (no gradient);
  3. jump to the 1000-step grid: ts1000[t_to * 1000 / max_denoising_steps];
  4. frozen eps for the positive / neutral / unconditional prompts with the
     slider OFF, as one batched UNet call (guidance 1 makes the reference's
     CFG-doubled pass equal to the conditional prediction);
  5. eps for the target prompt with the slider ON (the grad pass);
  6. f32 MSE against neutral + g_signed * (positive - unconditional), where
     erase is enhance at -g; then one optimizer update of the LoRA.

PyTorch runs the iteration eagerly: the partial denoise is a Python loop of
t_to UNet calls (the JAX package's traced-trip-count `fori_loop`), and the
grad pass is `torch.autograd.grad` of the loss with respect to the LoRA
leaves. The draws of step 1 come from a `torch.Generator` seeded from
(seed, step), so a resumed run repeats the draws of the run it continues,
which is what the JAX package's `fold_in(key, step)` gives; the streams
differ from JAX's threefry, so a parity test passes the draws in.

Not ported (each raises when asked for): SDXL (`is_xl`, ROADMAP queue 1,
item 6), the `fused_tail`, `denoise_merged` and `chunk > 1` variants
(item 18), a device mesh (item 15), and samplers other than DDIM (item 4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from sliders_tpu_torch.diffusion.guidance import train_grid_tables
from sliders_tpu_torch.diffusion.schedulers import DiffusionSchedule, Sampler
from sliders_tpu_torch.models import unet2d
from sliders_tpu_torch.ops.basic import SliderLora
from sliders_tpu_torch.training.optimizers import SliderOptimizer


@dataclass
class SliderTrainState:
    """Step count, f32 master LoRA, optimizer state and the seed of the
    draws; `state_dict`/`from_state_dict` are the `.pt` train-state file."""

    step: int
    lora: dict
    opt_state: dict
    seed: int

    @classmethod
    def create(cls, seed: int, lora: dict, optimizer: SliderOptimizer) -> "SliderTrainState":
        return cls(step=0, lora=lora, opt_state=optimizer.init(lora), seed=seed)

    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.seed, "lora": _tree_to(self.lora, "cpu"),
                "opt_state": _tree_to(self.opt_state, "cpu")}

    @classmethod
    def from_state_dict(cls, d: dict, device) -> "SliderTrainState":
        return cls(step=int(d["step"]), lora=_tree_to(d["lora"], device),
                   opt_state=_tree_to(d["opt_state"], device), seed=int(d["seed"]))


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def stack_prompt_pairs(pairs: list) -> dict:
    """Per-pair dicts (target/positive/neutral/unconditional (L, D) and the
    guidance_signed scalar) -> tensors with a leading pair axis."""
    return {k: torch.stack([torch.as_tensor(p[k]) for p in pairs]) for k in pairs[0]}


def step_draws(seed: int, step: int, n_pairs: int, max_denoising_steps: int,
               latent_shape: tuple, init_noise_sigma: float):
    """(pair index, t_to, latents) of iteration `step`: a CPU generator seeded
    from (seed, step), so every device and every resumed run draws the same."""
    gen = torch.Generator().manual_seed(((seed % 2**32) << 32) | (step % 2**32))
    pair_idx = int(torch.randint(n_pairs, (1,), generator=gen))
    t_to = int(torch.randint(1, max_denoising_steps, (1,), generator=gen))
    latents = torch.randn(latent_shape, generator=gen) * init_noise_sigma
    return pair_idx, t_to, latents


class _PhaseTimer:
    """CUDA events at the phase boundaries of one iteration (no host sync
    until the step reads its loss); on the CPU it records nothing."""

    def __init__(self, device: torch.device):
        self.marks = [] if device.type == "cuda" else None

    def mark(self, name: str) -> None:
        if self.marks is not None:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append((name, event))

    def phase_ms(self) -> Optional[dict]:
        if not self.marks:
            return None
        self.marks[-1][1].synchronize()
        return {name: start.elapsed_time(end)
                for (_, start), (name, end) in zip(self.marks, self.marks[1:])}


def make_text_slider_step(
    unet_cfg: unet2d.UNetConfig,
    schedule: DiffusionSchedule,
    sampler: Sampler,
    optimizer: SliderOptimizer,
    *,
    max_denoising_steps: int = 50,
    resolution=512,
    batch_size: int = 1,
    denoise_guidance: float = 3.0,
    compute_dtype=torch.bfloat16,
    remat: bool = True,
    mesh=None,
    is_xl: bool = False,
    denoise_merged: bool = False,
    fused_tail: bool = False,
    chunk: int = 1,
):
    """Build `step(state, unet_params, pairs, draws=None) -> (state, metrics)`.

    `pairs` is `stack_prompt_pairs` output on the UNet's device. `draws`, if
    given, is (pair index, t_to, latents) in place of `step_draws`. The step
    updates `state` in place (LoRA, optimizer state, step + 1) and returns
    it with the metrics loss, t_to, pair, grad_norm (Python numbers) and,
    on CUDA, phase_ms: the device time of the denoise loop, the frozen pass,
    the grad pass (forward and backward) and the update."""
    if is_xl:
        raise NotImplementedError("SDXL slider training is not ported yet (ROADMAP queue 1, item 6)")
    if fused_tail or denoise_merged or chunk != 1:
        raise NotImplementedError("the fused_tail, denoise_merged and chunk > 1 step variants are "
                                  "not ported yet (ROADMAP queue 1, item 18)")
    if mesh is not None:
        raise NotImplementedError("a device mesh is not ported yet (ROADMAP queue 1, item 15)")
    if sampler.kind != "ddim":
        raise NotImplementedError(f"the {sampler.kind!r} sampler is not ported yet "
                                  "(ROADMAP queue 1, item 4)")
    ts1000, scale1000 = train_grid_tables(schedule, sampler.kind)
    grid_stride = schedule.num_train_timesteps // max_denoising_steps
    height, width = resolution if isinstance(resolution, tuple) else (resolution, resolution)
    latent_shape = (batch_size, height // 8, width // 8, unet_cfg.in_channels)

    def unet(params, x, t, ehs, lora=None):
        return unet2d.apply(params, unet_cfg, x, t, ehs, lora=lora, remat=remat)

    def rep(e):
        """(...) -> (batch_size, ...) in the compute dtype."""
        return e.expand(batch_size, *e.shape).to(compute_dtype)

    def step(state: SliderTrainState, unet_params: dict, pairs: dict, draws=None):
        device = pairs["target"].device
        n_pairs = pairs["target"].shape[0]
        if draws is None:
            draws = step_draws(state.seed, state.step, n_pairs, max_denoising_steps,
                               latent_shape, sampler.init_noise_sigma)
        idx, t_to, latents = draws
        idx, t_to = int(idx), int(t_to)
        if not (0 <= idx < n_pairs and 1 <= t_to < max_denoising_steps):
            raise ValueError(f"draws out of range: pair {idx} of {n_pairs}, t_to {t_to}")
        pair = {k: v[idx] for k, v in pairs.items()}
        timer = _PhaseTimer(device)
        timer.mark("start")

        # 2. partial denoise, slider ON, CFG at denoise_guidance
        with torch.no_grad():
            x = torch.as_tensor(latents).to(device=device, dtype=compute_dtype)
            lora_on = SliderLora(weights=state.lora, multiplier=1.0)
            ehs_cfg = torch.cat([rep(pair["unconditional"]), rep(pair["target"])])
            timesteps = sampler.timesteps.to(device)
            s_state = sampler.init_state(x)
            for i in range(t_to):
                x_in = sampler.scale_model_input(torch.cat([x, x]), i).to(compute_dtype)
                eps = unet(unet_params, x_in, timesteps[i], ehs_cfg, lora=lora_on)
                eps_u, eps_c = eps.chunk(2)
                eps_g = eps_u + denoise_guidance * (eps_c - eps_u)
                x, s_state = sampler.step(i, eps_g, x, s_state)
                x = x.to(compute_dtype)
            timer.mark("denoise")

            # 3. jump onto the 1000-step grid (the scale is f32, as in JAX)
            t_idx = t_to * grid_stride
            t_cur = ts1000[t_idx].to(device)
            x_scaled = (x.float() * scale1000[t_idx].to(device)).to(compute_dtype)

            # 4. frozen eps: one batched pass, slider OFF
            ehs3 = torch.cat([rep(pair["positive"]), rep(pair["neutral"]),
                              rep(pair["unconditional"])])
            frozen = unet(unet_params, x_scaled.repeat(3, 1, 1, 1), t_cur, ehs3).float()
            eps_pos, eps_neu, eps_unc = frozen.chunk(3)
            goal = eps_neu + pair["guidance_signed"] * (eps_pos - eps_unc)
            timer.mark("frozen")

        # 5 + 6. grad pass on the target prompt, slider ON
        leaves = {m: {k: t.detach().requires_grad_() for k, t in e.items()}
                  for m, e in state.lora.items()}
        eps_t = unet(unet_params, x_scaled, t_cur, rep(pair["target"]),
                     lora=SliderLora(weights=leaves, multiplier=1.0)).float()
        diff = eps_t - goal
        loss = torch.mean(diff * diff)
        flat = [t for e in leaves.values() for t in e.values()]
        flat_grads = torch.autograd.grad(loss, flat, allow_unused=True)
        flat_grads = [torch.zeros_like(t) if g is None else g for t, g in zip(flat, flat_grads)]
        it = iter(flat_grads)
        grads = {m: {k: next(it) for k in e} for m, e in leaves.items()}
        timer.mark("grad")

        optimizer.update(state.lora, grads, state.opt_state)
        state.step += 1
        grad_norm = torch.sqrt(sum((g.float() ** 2).sum() for g in flat_grads))
        timer.mark("update")
        metrics = {"loss": loss.item(), "t_to": t_to, "pair": idx,
                   "grad_norm": grad_norm.item(), "phase_ms": timer.phase_ms()}
        return state, metrics

    return step
