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

SDXL (`is_xl`): every UNet call also takes its roles' pooled embeddings and
the pair's time ids (`pooled_*`, `time_ids` in the pairs). A pair with
`dynamic_crops` set draws a new crop every iteration, one shared by all four
roles (train_lora_xl.py:198-203); its three uniforms are the fourth entry of
the draws.

Every sampler kind runs the denoise loop (`scale_model_input`, then `step`,
as the JAX step does); the ancestral ones (ddpm, euler_a) take one noise
tensor of the latents' shape per denoise step, the fifth entry of the draws
(t_to of them, drawn last).

Under f16 compute (`precision: fp16`) cuBLAS sums the step's f16 GEMMs in
f32 (`ops.basic.f16_sums_in_f32`), as the JAX package does.

Under a process mesh (`mesh=`, `parallel/mesh.py`) the row axis of every
fan-out is split over dp where the JAX step constrains it
(`constrain_batch`): the CFG-doubled denoise input (2B rows) and the 3B-row
frozen pass run on each rank's rows and are gathered whole for the CFG
combine and the loss's targets; the B-row grad pass runs on each rank's
rows, its LoRA gradient made whole by `all_reduce_grads`, and the loss is
the global mean. Every rank draws the same (seed, step) stream, holds the
whole LoRA and applies the same update. tp splits the attention and
feed-forward blocks (`collectives.tensor_parallel`).

Not ported (each raises when asked for): the `fused_tail`, `denoise_merged`
and `chunk > 1` variants (ROADMAP queue 1, item 18).
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from sliders_tpu_torch.diffusion.guidance import train_grid_tables
from sliders_tpu_torch.diffusion.schedulers import DiffusionSchedule, Sampler
from sliders_tpu_torch.models import unet2d
from sliders_tpu_torch.ops.basic import SliderLora, f16_sums_in_f32
from sliders_tpu_torch.parallel.collectives import (
    all_reduce_grads,
    all_reduce_sum,
    gather_rows,
    row_range,
    scatter_rows,
    tensor_parallel,
)
from sliders_tpu_torch.pipelines.text2image import get_add_time_ids
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


def mix64(x: int) -> int:
    """splitmix64's finaliser: a bijection of 64-bit integers whose every
    output bit depends on every input bit."""
    x %= 2**64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) % 2**64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) % 2**64
    return x ^ (x >> 31)


def draw_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of iteration `step`'s draws, seeded from (seed,
    step), so every device and every resumed run draws the same. torch's
    CPU generator (mt19937) keeps only the low 32 bits of its seed, so
    (seed, step) is mixed into them (`mix64`): another seed draws another
    stream."""
    return torch.Generator().manual_seed(
        mix64(((seed % 2**32) << 32) | (step % 2**32)) % 2**32)


def lora_leaves(lora: dict) -> dict:
    """The LoRA's tensors as fresh leaves that the grad pass differentiates."""
    return {m: {k: t.detach().requires_grad_() for k, t in e.items()} for m, e in lora.items()}


def backward_and_update(state: SliderTrainState, optimizer: SliderOptimizer,
                        loss: torch.Tensor, leaves: dict, timer: _PhaseTimer) -> torch.Tensor:
    """The gradient of `loss` with respect to `leaves` (zeros for a leaf the
    loss does not reach), then the optimizer's in-place update of
    `state.lora` and `state.step + 1`; marks the timer's "grad" and
    "update" phases and returns the gradient's global norm."""
    grads = lora_grads(loss, leaves)
    timer.mark("grad")
    optimizer.update(state.lora, grads, state.opt_state)
    state.step += 1
    grad_norm = torch.sqrt(sum((g.float() ** 2).sum() for e in grads.values()
                               for g in e.values()))
    timer.mark("update")
    return grad_norm


def lora_grads(loss: torch.Tensor, leaves: dict) -> dict:
    """The gradient of `loss` with respect to `leaves`, as a tree of the
    same structure (zeros for a leaf the loss does not reach)."""
    flat = [t for e in leaves.values() for t in e.values()]
    flat_grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(torch.zeros_like(t) if g is None else g for t, g in zip(flat, flat_grads))
    return {m: {k: next(it) for k in e} for m, e in leaves.items()}


def step_draws(seed: int, step: int, n_pairs: int, max_denoising_steps: int,
               latent_shape: tuple, init_noise_sigma: float, crop: bool = False,
               ancestral: bool = False, t_to_rule=None):
    """(pair index, t_to, latents) of iteration `step`, from
    `draw_generator(seed, step)`. With `crop` (SDXL), a fourth entry
    follows: (scale in [1, 3), u_top, u_left), the uniforms of a dynamic
    crop (`get_add_time_ids`). With `ancestral` (ddpm, euler_a), a fifth,
    drawn last: the denoise loop's noise, (t_to, *latent_shape); the fourth
    is then None without `crop`. `t_to_rule(t_to, generator)`, if given
    (a fleet row, `training/fleet.py`), replaces the drawn t_to after the
    crop, drawing from the same generator what it needs; the noise follows
    the t_to it returns."""
    gen = draw_generator(seed, step)
    pair_idx = int(torch.randint(n_pairs, (1,), generator=gen))
    t_to = int(torch.randint(1, max_denoising_steps, (1,), generator=gen))
    latents = torch.randn(latent_shape, generator=gen) * init_noise_sigma
    draws = [pair_idx, t_to, latents]
    if crop:
        u = torch.rand(3, generator=gen)
        draws.append((1.0 + 2.0 * u[0], u[1], u[2]))
    if t_to_rule is not None:
        t_to = draws[1] = int(t_to_rule(t_to, gen))
    if ancestral:
        if not crop:
            draws.append(None)
        draws.append(torch.randn((t_to, *latent_shape), generator=gen))
    return tuple(draws)


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


def run_under(context, step):
    """`step` run inside `context()`, its backward too."""

    @functools.wraps(step)
    def wrapped(*args, **kwargs):
        with context():
            return step(*args, **kwargs)

    return wrapped


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
    given, is (pair index, t_to, latents[, crop[, ancestral noise]]) in
    place of `step_draws`; the crop entry is needed only by a pair with
    dynamic crops, the noise (t_to or more per-step tensors of the latents'
    shape) only by ddpm and euler_a. The step
    updates `state` in place (LoRA, optimizer state, step + 1) and returns
    it with the metrics loss, t_to, pair, grad_norm (Python numbers) and,
    on CUDA, phase_ms: the device time of the denoise loop, the frozen pass,
    the grad pass (forward and backward) and the update. It runs under
    `f16_sums_in_f32`."""
    if fused_tail or denoise_merged or chunk != 1:
        raise NotImplementedError("the fused_tail, denoise_merged and chunk > 1 step variants are "
                                  "not ported yet (ROADMAP queue 1, item 18)")
    ts1000, scale1000 = train_grid_tables(schedule, sampler.kind)
    grid_stride = schedule.num_train_timesteps // max_denoising_steps
    height, width = resolution if isinstance(resolution, tuple) else (resolution, resolution)
    latent_shape = (batch_size, height // 8, width // 8, unet_cfg.in_channels)

    def unet(params, x, t, ehs, added, lora=None):
        return unet2d.apply(params, unet_cfg, x, t, ehs, added_cond=added, lora=lora,
                            remat=remat)

    def unet_rows(params, x, t, ehs, added, lora=None):
        """`unet` on this rank's rows of an n-row fan-out (all of them
        without a mesh), the outputs gathered whole over dp."""
        if mesh is None:
            return unet(params, x, t, ehs, added, lora)
        n = x.shape[0]
        x, ehs = scatter_rows(x, mesh), scatter_rows(ehs, mesh)
        out = x.new_empty((0, *x.shape[1:3], unet_cfg.out_channels))
        if len(x):
            out = unet(params, x, t, ehs,
                       None if added is None else {k: scatter_rows(v, mesh)
                                                   for k, v in added.items()}, lora)
        return gather_rows(out, n, mesh)

    def rep(e):
        """(...) -> (batch_size, ...) in the compute dtype (the time ids too,
        as in the JAX step)."""
        return e.expand(batch_size, *e.shape).to(compute_dtype)

    def added_from(pair, role):
        if not is_xl:
            return None
        return {"text_embeds": rep(pair[f"pooled_{role}"]), "time_ids": rep(pair["time_ids"])}

    def added_concat(*adds):
        if adds[0] is None:
            return None
        return {k: torch.cat([a[k] for a in adds]) for k in adds[0]}

    def step(state: SliderTrainState, unet_params: dict, pairs: dict, draws=None):
        device = pairs["target"].device
        n_pairs = pairs["target"].shape[0]
        if draws is None:
            draws = step_draws(state.seed, state.step, n_pairs, max_denoising_steps,
                               latent_shape, sampler.init_noise_sigma, crop=is_xl,
                               ancestral=sampler.stochastic)
        idx, t_to, latents, *rest = draws
        crop = rest[0] if rest else None
        noise = rest[1] if len(rest) > 1 else None
        idx, t_to = int(idx), int(t_to)
        if not (0 <= idx < n_pairs and 1 <= t_to < max_denoising_steps):
            raise ValueError(f"draws out of range: pair {idx} of {n_pairs}, t_to {t_to}")
        if sampler.stochastic and (noise is None or len(noise) < t_to):
            raise ValueError(f"the {sampler.kind} denoise loop needs {t_to} ancestral draws")
        pair = {k: v[idx] for k, v in pairs.items()}
        if is_xl and "dynamic_crops" in pair:
            if crop is None:
                raise ValueError("an SDXL pair with dynamic_crops needs the crop draws")
            dyn_ids = get_add_time_ids(height, width, dynamic_crops=True, draws=crop)[0]
            pair["time_ids"] = torch.where(pair["dynamic_crops"] > 0,
                                           dyn_ids.to(device, pair["time_ids"].dtype),
                                           pair["time_ids"])
        timer = _PhaseTimer(device)
        timer.mark("start")

        # 2. partial denoise, slider ON, CFG at denoise_guidance
        with torch.no_grad():
            x = torch.as_tensor(latents).to(device=device, dtype=compute_dtype)
            lora_on = SliderLora(weights=state.lora, multiplier=1.0)
            ehs_cfg = torch.cat([rep(pair["unconditional"]), rep(pair["target"])])
            added_cfg = added_concat(added_from(pair, "unconditional"), added_from(pair, "target"))
            timesteps = sampler.timesteps.to(device)
            s_state = sampler.init_state(x)
            for i in range(t_to):
                x_in = sampler.scale_model_input(torch.cat([x, x]), i).to(compute_dtype)
                eps = unet_rows(unet_params, x_in, timesteps[i], ehs_cfg, added_cfg,
                                lora=lora_on)
                eps_u, eps_c = eps.chunk(2)
                eps_g = eps_u + denoise_guidance * (eps_c - eps_u)
                x, s_state = sampler.step(i, eps_g, x, s_state,
                                          noise=None if noise is None else noise[i])
                x = x.to(compute_dtype)
            timer.mark("denoise")

            # 3. jump onto the 1000-step grid (the scale is f32, as in JAX)
            t_idx = t_to * grid_stride
            t_cur = ts1000[t_idx].to(device)
            x_scaled = (x.float() * scale1000[t_idx].to(device)).to(compute_dtype)

            # 4. frozen eps: one batched pass, slider OFF
            ehs3 = torch.cat([rep(pair["positive"]), rep(pair["neutral"]),
                              rep(pair["unconditional"])])
            added3 = added_concat(*(added_from(pair, r)
                                    for r in ("positive", "neutral", "unconditional")))
            frozen = unet_rows(unet_params, x_scaled.repeat(3, 1, 1, 1), t_cur, ehs3,
                               added3).float()
            eps_pos, eps_neu, eps_unc = frozen.chunk(3)
            goal = eps_neu + pair["guidance_signed"] * (eps_pos - eps_unc)
            timer.mark("frozen")

        # 5 + 6. grad pass on the target prompt, slider ON
        leaves = lora_leaves(state.lora)
        if mesh is None:
            eps_t = unet(unet_params, x_scaled, t_cur, rep(pair["target"]),
                         added_from(pair, "target"),
                         lora=SliderLora(weights=leaves, multiplier=1.0)).float()
            diff = eps_t - goal
            loss = torch.mean(diff * diff)
            grad_norm = backward_and_update(state, optimizer, loss, leaves, timer)
        else:
            loss, grad_norm = mesh_grad_pass(
                state, optimizer, leaves, timer, mesh, goal,
                lambda lo, hi: unet(
                    unet_params, x_scaled[lo:hi], t_cur, rep(pair["target"])[lo:hi],
                    (None if not is_xl else
                     {k: v[lo:hi] for k, v in added_from(pair, "target").items()}),
                    lora=SliderLora(weights=leaves, multiplier=1.0)).float())
        metrics = {"loss": loss.item(), "t_to": t_to, "pair": idx,
                   "grad_norm": grad_norm.item(), "phase_ms": timer.phase_ms()}
        return state, metrics

    return run_under(functools.partial(_step_context, mesh), step)


@contextlib.contextmanager
def _step_context(mesh):
    """`f16_sums_in_f32` and the mesh's tp split (`tensor_parallel`)."""
    with f16_sums_in_f32(), tensor_parallel(mesh):
        yield


def mesh_grad_pass(state: SliderTrainState, optimizer: SliderOptimizer, leaves: dict,
                   timer: _PhaseTimer, mesh, target: torch.Tensor, forward,
                   scale: float = 1.0) -> tuple:
    """The grad pass of a step whose loss is `scale` * mean((out - target)^2)
    over `target`'s n rows, with this rank's rows [lo, hi) of them
    (`row_range` over dp) computed by `forward(lo, hi)`: the rank's share of
    the loss sum, differentiated with respect to `leaves` (zeros on a rank
    without rows), made whole by `all_reduce_grads` (the sum over tp of the
    split modules' leaves, the mean over dp, so the rank's share is scaled
    by dp), then the optimizer's update of `state`. Returns the global loss
    and the gradient's global norm."""
    lo, hi = row_range(target.shape[0], mesh.size("dp"), mesh.coord("dp"))
    part = torch.zeros((), device=target.device)
    if hi > lo:
        diff = forward(lo, hi) - target[lo:hi]
        part = scale * (diff * diff).sum() / target.numel()
        grads = lora_grads(part * mesh.size("dp"), leaves)
    else:
        grads = {m: {k: torch.zeros_like(t) for k, t in e.items()} for m, e in leaves.items()}
    grads = all_reduce_grads(grads, mesh)
    timer.mark("grad")
    optimizer.update(state.lora, grads, state.opt_state)
    state.step += 1
    grad_norm = torch.sqrt(sum((g.float() ** 2).sum() for e in grads.values()
                               for g in e.values()))
    timer.mark("update")
    return all_reduce_sum(part.float(), mesh), grad_norm
