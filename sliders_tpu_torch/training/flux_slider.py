"""FLUX text-slider training step, flow matching
(port of sliders_tpu/training/flux_slider.py).

Per iteration, as in the JAX step (the reference's FLUX notebook is missing
from its snapshot; flux-sliders/utils and its README specify it):
  1. draw a prompt pair, t_to in [1, n_steps) and unit-normal packed noise;
  2. integrate the flow t_to FlowMatch-Euler steps from the noise with the
     slider merged into the weights at 1.0 (no gradient);
  3. velocities for the positive / neutral / unconditional prompts on the
     unmerged weights, as one batch-3 pass; goal = neutral + g_signed *
     (positive - unconditional) in f32;
  4. the target prompt's velocity on the weights merged at 1.0 under
     autograd (`lora/merge.py`, as the JAX step merges inside its loss), f32
     MSE against the goal; the gradients of the leaves the trainable mask
     freezes are zero (with ortho_up, `up`); one optimizer update.
FLUX-dev has no CFG batch doubling: guidance is an embedding, here
`transformer_guidance`.

PyTorch runs the iteration eagerly. The JAX step scans n_steps - 1 masked
Euler steps (steps past t_to leave x as it is); the port runs exactly t_to,
which gives the same x. The draws come from `text_slider.step_draws`, a
generator seeded from (seed, step); a parity test passes JAX's draws in.

Under a dp x tp process mesh (`mesh=`, `parallel/mesh.py`), where the JAX
step shards the batch over dp (`constrain_batch`): every rank draws the
whole noise from the same (seed, step) stream and denoises its rows
(`row_range` over dp), the rows gathered once for the 3B-row frozen pass,
which splits over dp and is gathered whole for the goal; the B-row grad
pass runs on each rank's rows and its LoRA gradient is made whole by
`all_reduce_grads` (the sum over tp of the split modules' shares, the
mean over dp), so every rank applies the world-1 update. tp splits the
MMDiT's blocks (`models/flux.py`) and the merged deltas (`lora/merge.py`);
the LoRA stays whole on every rank.

Refused by name: a `pp` axis and `pp_microbatches > 1` (the differentiable
pipeline, ROADMAP queue 1, item 15), `chunk > 1` (item 18; it only batches
dispatch, so the CLI calls the step once per iteration and saves at the
same steps).
"""

from __future__ import annotations

import torch

from sliders_tpu_torch.diffusion.schedulers import FlowMatchSampler
from sliders_tpu_torch.lora.merge import merge_lora_weights
from sliders_tpu_torch.models import flux
from sliders_tpu_torch.parallel.collectives import (
    all_reduce_grads,
    all_reduce_sum,
    gather_rows,
    row_range,
    tensor_parallel,
)
from sliders_tpu_torch.training.optimizers import SliderOptimizer
from sliders_tpu_torch.training.text_slider import (
    SliderTrainState,
    _PhaseTimer,
    run_under,
    step_draws,
)

ROLES = ("target", "positive", "neutral", "unconditional")


def make_flux_slider_step(
    cfg: flux.FluxConfig,
    sampler: FlowMatchSampler,
    optimizer: SliderOptimizer,
    *,
    resolution: int = 512,
    batch_size: int = 1,
    transformer_guidance: float = 1.0,
    compute_dtype=torch.bfloat16,
    remat: bool = True,
    mesh=None,
    trainable_mask=None,
    chunk: int = 1,
    pp_microbatches: int = 1,
):
    """Build `step(state, flux_params, pairs, draws=None) -> (state, metrics)`.

    `pairs` is `stack_prompt_pairs` output on the transformer's device, with
    `{role}_t5` (n, L_t5, joint_dim), `{role}_pooled` (n, pooled_dim) per
    prompt role and `guidance_signed` (n,). `draws`, if given, is (pair
    index, t_to, noise (batch_size, L_img, in_channels)) in place of
    `step_draws`. `trainable_mask` (default: the optimizer's) names the
    leaves that get a gradient. The step updates `state` in place and
    returns it with the metrics loss, t_to, pair, grad_norm (of the masked
    gradients) and, on CUDA, phase_ms: the device time of the denoise loop,
    the frozen pass, the grad pass (forward and backward) and the update.
    `mesh`: a dp x tp process mesh (see the module docstring), with
    `flux_params` this rank's tp shards (`parallel.mesh.tp_keep`); every rank
    returns the same metrics and LoRA."""
    if (mesh is not None and mesh.size("pp") > 1) or pp_microbatches != 1:
        raise NotImplementedError("pipeline-parallel FLUX training (a pp mesh, pp_microbatches > "
                                  "1) is not ported yet (ROADMAP queue 1, item 15)")
    if chunk != 1:
        raise NotImplementedError("chunk > 1 (several iterations per dispatch) is not ported yet "
                                  "(ROADMAP queue 1, item 18)")
    latent_hw = resolution // 8  # VAE factor 8, then 2x2 packing
    noise_shape = (batch_size, (latent_hw // 2) ** 2, cfg.in_channels)
    img_ids = flux.image_ids(latent_hw, latent_hw)
    n_steps = sampler.num_steps
    mask = trainable_mask if trainable_mask is not None else optimizer.trainable_mask

    def model(params, x, t_norm, pooled, txt):
        B = x.shape[0]
        g = None
        if cfg.guidance_embeds:
            g = torch.full((B,), transformer_guidance, dtype=torch.float32, device=x.device)
        return flux.apply(params, cfg, x, t_norm.expand(B), pooled, txt,
                          flux.text_ids(txt.shape[1]), img_ids, guidance=g, remat=remat)

    def rep(e):
        """(...) -> (batch_size, ...) in the compute dtype."""
        return e.expand(batch_size, *e.shape).to(compute_dtype)

    def trainable(m, k):
        return mask is None or mask[m][k]

    def rows(n):
        """This rank's rows [lo, hi) of an n-row fan-out (all without a mesh)."""
        return (0, n) if mesh is None else row_range(n, mesh.size("dp"), mesh.coord("dp"))

    def model_rows(params, x, t_norm, pooled, txt):
        """`model` on this rank's rows of an n-row fan-out, gathered whole
        over dp (a rank without rows skips the transformer)."""
        if mesh is None:
            return model(params, x, t_norm, pooled, txt)
        lo, hi = rows(x.shape[0])
        out = x.new_empty((0, *x.shape[1:]))
        if hi > lo:
            out = model(params, x[lo:hi], t_norm, pooled[lo:hi], txt[lo:hi])
        return gather_rows(out, x.shape[0], mesh)

    def step(state: SliderTrainState, params: dict, pairs: dict, draws=None):
        device = pairs["target_t5"].device
        n_pairs = pairs["target_t5"].shape[0]
        if draws is None:
            draws = step_draws(state.seed, state.step, n_pairs, n_steps, noise_shape, 1.0)
        idx, t_to, noise = draws
        idx, t_to = int(idx), int(t_to)
        if not (0 <= idx < n_pairs and 1 <= t_to < n_steps):
            raise ValueError(f"draws out of range: pair {idx} of {n_pairs}, t_to {t_to}")
        pair = {k: v[idx] for k, v in pairs.items()}
        timesteps = sampler.timesteps.to(device)
        timer = _PhaseTimer(device)
        timer.mark("start")

        with torch.no_grad():
            # 2. t_to Euler steps with the slider merged at 1.0, on this
            # rank's rows of the whole draw
            merged = merge_lora_weights(params, state.lora, 1.0, mesh)
            lo, hi = rows(batch_size)
            x = torch.as_tensor(noise)[lo:hi].to(device=device, dtype=compute_dtype)
            pooled_t, txt_t = rep(pair["target_pooled"]), rep(pair["target_t5"])
            if hi > lo:
                for i in range(t_to):
                    v = model(merged, x, timesteps[i] / 1000.0, pooled_t[lo:hi], txt_t[lo:hi])
                    x = sampler.step(i, v, x).to(compute_dtype)
            if mesh is not None:
                x = gather_rows(x, batch_size, mesh)
            del merged
            timer.mark("denoise")

            # 3. frozen velocities: one batch-3 pass on the unmerged weights
            t_norm = timesteps[t_to] / 1000.0
            txt3 = torch.cat([rep(pair[f"{r}_t5"]) for r in ROLES[1:]])
            pooled3 = torch.cat([rep(pair[f"{r}_pooled"]) for r in ROLES[1:]])
            frozen = model_rows(params, x.repeat(3, 1, 1), t_norm, pooled3, txt3).float()
            v_pos, v_neu, v_unc = frozen.chunk(3)
            goal = v_neu + pair["guidance_signed"] * (v_pos - v_unc)
            del frozen, v_pos, v_neu, v_unc
            timer.mark("frozen")

        # 4. the grad pass on the target prompt, slider merged at 1.0
        leaves = {m: {k: t.detach().requires_grad_(trainable(m, k)) for k, t in e.items()}
                  for m, e in state.lora.items()}
        flat = [t for e in leaves.values() for t in e.values() if t.requires_grad]
        if mesh is None:
            v_t = model(merge_lora_weights(params, leaves, 1.0), x, t_norm, pooled_t,
                        txt_t).float()
            diff = v_t - goal
            loss = torch.mean(diff * diff)
            flat_grads = torch.autograd.grad(loss, flat)
            del v_t, diff
        else:
            # this rank's share of the loss sum, scaled by dp so that the dp
            # mean of the gradients is the global loss's
            part = torch.zeros((), device=device)
            flat_grads = [torch.zeros_like(t) for t in flat]
            if hi > lo:
                v_t = model(merge_lora_weights(params, leaves, 1.0, mesh), x[lo:hi], t_norm,
                            pooled_t[lo:hi], txt_t[lo:hi]).float()
                diff = v_t - goal[lo:hi]
                part = (diff * diff).sum() / goal.numel()
                flat_grads = torch.autograd.grad(part * mesh.size("dp"), flat)
                del v_t, diff
            loss = all_reduce_sum(part.float(), mesh)
        it = iter(flat_grads)
        grads = {m: {k: next(it) if t.requires_grad else torch.zeros_like(t)
                     for k, t in e.items()} for m, e in leaves.items()}
        if mesh is not None:
            grads = all_reduce_grads(grads, mesh)
        timer.mark("grad")

        optimizer.update(state.lora, grads, state.opt_state)
        state.step += 1
        grad_norm = torch.sqrt(sum((g.float() ** 2).sum() for e in grads.values()
                                   for g in e.values()))
        timer.mark("update")
        metrics = {"loss": loss.item(), "t_to": t_to, "pair": idx,
                   "grad_norm": grad_norm.item(), "phase_ms": timer.phase_ms()}
        return state, metrics

    if mesh is None:
        return step
    return run_under(lambda: tensor_parallel(mesh), step)
