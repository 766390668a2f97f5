"""Fleet training: K independent sliders trained in one step
(port of sliders_tpu/training/fleet.py).

The reference trains one slider per process (train_lora.py:32-340), so the
repo's dozens of example sliders (data/prompts-*.yaml) are dozens of runs.
A fleet trains K of them at once: every adapter leaf carries a leading (K,)
slider axis (`stack_fleet`), and each UNet call of the iteration is one
batched call in which row r applies, and backpropagates into, row r's
factors only (the per-row stacked LoRA of `lora/batch.py` and
`ops/basic.py`). One process and one set of UNet calls per phase make K
artifacts; rows never exchange data, so each row's loss, gradient and
update are its own.

Row contract. Row r is the solo port run with seed `fleet_row_seed(seed,
r)`: its initial LoRA is the one a solo run draws from that seed + 1, and
each iteration it draws what `text_slider.step_draws(fleet_row_seed(seed,
r), step, n_pairs[r], ...)` draws (pair, t_to, latents, the SDXL crop, the
ancestral noises). This is the port's counterpart of the JAX rule "row r ==
solo run keyed fold_in(fleet_key, r)"; the streams are torch's, not
threefry's, so a parity test passes the JAX package's draws in. One
structural difference from a solo run, kept from the JAX step: the partial
denoise runs to max_r(t_to_r) with the rows past their own t_to frozen (the
latents and every sampler-state leaf, by structure: the LMS history is
(ORDER, K*B, ...) and is masked on its row axis, never by shape).

`t_to_mode` sets the joint distribution of the K rows' t_to (each row's
marginal stays Uniform{1..T-1}; see `make_fleet_text_step`): `per_row`
(the solo streams), `shared` (every row takes row 0's draw) and
`stratified` (a stratum s ~ Uniform{0..S-1} from a stream of its own per
(seed, step), then t_to_r = 1 + floor((s + u_r)(T - 1) / S) with u_r
uniform from row r's stream after its crop draw; no row keeps the solo
stream there, as in the JAX package).

Optimizers: adamw, adam and lion update element by element, so rows stay
independent. prodigy and the D-Adaptation optimizers estimate one step size
over the whole tree and would couple the rows; the fleet refuses them by
name, as the JAX fleet does.

Row isolation on the card: the rows share every UNet call, and cuDNN's
default convolution algorithms do not repeat themselves from run to run, so
under them a row's bits could move with another row's data. The fleet's
steps run under cuDNN's deterministic algorithms (`deterministic_cudnn`),
which hold a rerun and a row's isolation to 0, bit for bit; the solo steps
keep cuDNN's defaults. Under f16 compute the text fleet sums its f16 GEMMs
in f32, as the solo text step does.

The dp-sharded fleet (`mesh=`, `parallel/mesh.py`): the K rows split over
the mesh's dp with their adapters and optimizer states, each rank training
K / dp sliders with no gradient collective (the per-row metrics are
gathered for the printout); K % dp raises. tp splits the UNet's blocks as
in the solo steps. The main rank writes every row's files.

The steps run eagerly, as the solo steps do. Not ported (it raises when
asked for): `chunk > 1` (ROADMAP queue 1, item 18).
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from sliders_tpu_torch.core.config import to_dict
from sliders_tpu_torch.data.paired_images import PairedImageFolders
from sliders_tpu_torch.diffusion.guidance import train_grid_tables
from sliders_tpu_torch.diffusion.schedulers import (
    DiffusionSchedule,
    Sampler,
    make_sampler,
    make_schedule,
)
from sliders_tpu_torch.lora import io as lora_io
from sliders_tpu_torch.lora import network as lnet
from sliders_tpu_torch.models import unet2d, vae
from sliders_tpu_torch.ops.basic import SliderLora, f16_sums_in_f32
from sliders_tpu_torch.parallel.collectives import (
    all_gather_rows,
    all_reduce_grads,
    tensor_parallel,
)
from sliders_tpu_torch.pipelines.text2image import get_add_time_ids
from sliders_tpu_torch.training.driver import (
    PromptEmbedsCache,
    _note_f32_under_fp16,
    _note_steps_per_call,
    _note_text_loop_only,
    _param_device,
    _save_due,
    _slider_optimizer,
    build_pairs,
    compute_dtype_of,
    draw_unet_lora,
    load_dtype_of,
    load_train_state,
    save_train_state,
    to_u8,
)
from sliders_tpu_torch.training.image_slider import image_step_draws
from sliders_tpu_torch.training.optimizers import ADAPTIVE_NAMES, SliderOptimizer
from sliders_tpu_torch.training.text_slider import (
    SliderTrainState,
    _PhaseTimer,
    draw_generator,
    lora_grads,
    lora_leaves,
    mix64,
    run_under,
    step_draws,
)

T_TO_MODES = ("per_row", "shared", "stratified")
_STRATUM_STREAM = 0x5742A7  # the stratum's own stream (the JAX step's fold constant)


# ---------------------------------------------------------------------------
# fleet tree helpers
# ---------------------------------------------------------------------------


def fleet_row_seed(seed: int, row: int) -> int:
    """The seed of fleet row `row`'s solo run: a splitmix64 mix of (seed,
    row), cut to 31 bits, so rows draw from unrelated streams and a solo
    run of that seed (draws from it, LoRA from it + 1) is row `row`."""
    return mix64(seed * 0x9E3779B97F4A7C15 + (row + 1) * 0xBF58476D1CE4E5B9) % 2**31


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside the block
    (`torch.backends.cudnn.deterministic = True`, `benchmark = False`), both
    flags restored after."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


@contextlib.contextmanager
def _fleet_step_flags(mesh=None):
    """`deterministic_cudnn` and, as in the solo text step,
    `f16_sums_in_f32`, with the mesh's tp split (`tensor_parallel`)."""
    with deterministic_cudnn(), f16_sums_in_f32(), tensor_parallel(mesh):
        yield


def refuse_global_optimizer(optimizer_name: str) -> None:
    """The JAX fleet's refusal of the optimizers with a global step size."""
    if optimizer_name.lower().replace("8bit", "").rstrip("_") in ADAPTIVE_NAMES:
        raise NotImplementedError(
            f"'{optimizer_name}' estimates a global step size over the whole "
            "tree and would couple fleet rows; use adamw/adam/lion")


def stack_fleet(loras: Sequence[dict]) -> dict:
    """Stack K solo adapter trees into one fleet tree ({module: {'down',
    'up', 'alpha'}} with a leading (K,) axis). Unlike the serving stacker
    (`lora/batch.stack_sliders`) it requires one factor shape per module
    (one rank: a fleet is one train config over many concepts) and adds no
    `rank` leaf, so `ops/basic` reads the rank from the factors' shape."""
    if not loras:
        raise ValueError("stack_fleet needs at least one adapter")
    names = sorted(loras[0])
    for w in loras[1:]:
        if sorted(w) != names:
            raise ValueError("fleet adapters target different module sets")
    out = {}
    for name in names:
        shapes = {tuple(w[name]["down"].shape) for w in loras}
        if len(shapes) != 1:
            raise ValueError(f"fleet adapters disagree on {name} down shape: {shapes} "
                             "(fleet training requires one rank for all sliders)")
        out[name] = {k: torch.stack([torch.as_tensor(w[name][k]) for w in loras])
                     for k in ("down", "up", "alpha")}
    return out


def unstack_fleet(stacked: dict) -> list:
    """Inverse of `stack_fleet`: the fleet tree -> K solo trees."""
    return [{name: {k: leaf[k][r] for k in ("down", "up", "alpha")}
             for name, leaf in stacked.items()} for r in range(fleet_size(stacked))]


def fleet_size(stacked: dict) -> int:
    return next(iter(stacked.values()))["alpha"].shape[0]


def stack_fleet_pairs(pair_sets: Sequence[dict]) -> dict:
    """K stacked pair dicts (`driver.build_pairs` output, each (n_r, ...))
    -> one (K, n_max, ...) dict and `n_pairs`, the (K,) int32 bounds on the
    CPU. Rows past a slider's n_r repeat its last pair and are never drawn
    (row r draws its pair index below n_pairs[r])."""
    if not pair_sets:
        raise ValueError("stack_fleet_pairs needs at least one pair set")
    keys = set(pair_sets[0])
    for p in pair_sets[1:]:
        if set(p) != keys:
            raise ValueError("fleet pair sets have different keys (XL vs SD mix?)")
    n = [next(iter(p.values())).shape[0] for p in pair_sets]
    n_max = max(n)

    def pad(a):
        a = torch.as_tensor(a)
        if a.shape[0] == n_max:
            return a
        return torch.cat([a, a[-1:].expand(n_max - a.shape[0], *a.shape[1:])])

    out = {k: torch.stack([pad(p[k]) for p in pair_sets]) for k in sorted(keys)}
    out["n_pairs"] = torch.tensor(n, dtype=torch.int32)
    return out


def _repeat_rows(tree: dict, reps: int) -> dict:
    """(K, ...) leaves -> (K * reps, ...), each row repeated `reps` times
    in place ([s0 x reps, s1 x reps, ...])."""
    if reps == 1:
        return tree
    return {m: {k: t.repeat_interleave(reps, dim=0) for k, t in e.items()}
            for m, e in tree.items()}


def _tile_tree(tree: dict, reps: int) -> dict:
    """(R, ...) leaves -> (R * reps, ...) by whole-block tiling (the CFG
    halves, the +-s halves)."""
    if reps == 1:
        return tree
    return {m: {k: torch.cat([t] * reps) for k, t in e.items()} for m, e in tree.items()}


# ---------------------------------------------------------------------------
# the draws
# ---------------------------------------------------------------------------


def draw_fleet_t_to(row_t_to: Sequence[int], max_denoising_steps: int, *, mode: str,
                    stratum: Optional[int] = None, u: Optional[Sequence[float]] = None,
                    strata: int = 8) -> list:
    """The K rows' partial-denoise depths for one fleet iteration, from each
    row's own Uniform{1..T-1} draw `row_t_to` (its solo stream), and for
    `stratified` the step's shared stratum `stratum` in [0, strata) and the
    rows' uniforms `u` in [0, 1). Every mode keeps each row's marginal
    Uniform{1..T-1}: `per_row` returns the rows' draws, `shared` row 0's
    for every row, `stratified` 1 + floor((stratum + u_r)(T - 1) / strata),
    clamped to [1, T - 1] (f32 rounding may reach T at u near 1)."""
    if mode == "per_row":
        return [int(t) for t in row_t_to]
    if mode == "shared":
        return [int(row_t_to[0])] * len(row_t_to)
    if mode != "stratified":
        raise ValueError(f"t_to_mode must be per_row/shared/stratified, got {mode!r}")
    R = max_denoising_steps - 1
    out = []
    for ur in u:
        v = np.float32((np.float32(stratum) + np.float32(ur)) * np.float32(R) / np.float32(strata))
        out.append(min(max(1 + int(math.floor(v)), 1), R))
    return out


def fleet_step_draws(seed: int, step: int, n_pairs: Sequence[int], max_denoising_steps: int,
                     latent_shape: tuple, init_noise_sigma: float, *, mode: str = "per_row",
                     strata: int = 8, crop: bool = False, ancestral: bool = False) -> list:
    """The K rows' draws of iteration `step`: row r's is `step_draws(
    fleet_row_seed(seed, r), step, n_pairs[r], ...)` with its t_to replaced
    by the mode's (`draw_fleet_t_to`); the ancestral noise follows the
    row's final t_to."""
    stratum = None
    if mode == "stratified":  # the step's stratum, from a stream of its own
        stratum = int(torch.randint(strata, (1,), generator=draw_generator(
            fleet_row_seed(seed, _STRATUM_STREAM), step)))
    rows: list = []
    for r, n in enumerate(n_pairs):
        def rule(t, gen):
            if mode == "per_row" or (mode == "shared" and r == 0):
                return t
            if mode == "shared":
                return rows[0][1]
            u = float(torch.rand((), generator=gen))
            return draw_fleet_t_to([t], max_denoising_steps, mode=mode, stratum=stratum, u=[u],
                                   strata=strata)[0]

        rows.append(step_draws(fleet_row_seed(seed, r), step, int(n), max_denoising_steps,
                               latent_shape, init_noise_sigma, crop=crop, ancestral=ancestral,
                               t_to_rule=rule))
    return rows


# ---------------------------------------------------------------------------
# the text fleet step
# ---------------------------------------------------------------------------


def _check_builder(optimizer: SliderOptimizer, optimizer_name: str, mesh, chunk: int,
                   K: int) -> tuple:
    """The builders' refusals; returns (local rows, first local row): the
    fleet's K rows split over the mesh's dp (K % dp raises the JAX
    package's ValueError)."""
    refuse_global_optimizer(optimizer_name)
    if optimizer is not None and optimizer.adaptive:
        refuse_global_optimizer(optimizer.kind.replace("_", ""))
    if chunk != 1:
        raise NotImplementedError("the chunk > 1 step variant is not ported yet "
                                  "(ROADMAP queue 1, item 18)")
    dp = 1 if mesh is None else mesh.size("dp")
    if K % dp:
        raise ValueError(f"fleet size {K} must divide over dp={dp}")
    return K // dp, (0 if mesh is None else mesh.coord("dp")) * (K // dp)


def _gather_metrics(metrics: dict, keys: tuple, mesh) -> dict:
    """The per-row metric lists of this rank's rows gathered over dp into
    the fleet's K (the step's only collective without tp)."""
    if mesh is None or mesh.size("dp") == 1:
        return metrics
    local = torch.tensor([metrics[k] for k in keys], dtype=torch.float64)  # (n_keys, K / dp)
    whole = all_gather_rows(local.T.contiguous(), mesh).T
    out = dict(metrics)
    for i, k in enumerate(keys):
        kind = type(metrics[k][0]) if metrics[k] else float
        out[k] = [kind(v) for v in whole[i].tolist()]
    return out


def make_fleet_text_step(
    unet_cfg: unet2d.UNetConfig,
    schedule: DiffusionSchedule,
    sampler: Sampler,
    optimizer: SliderOptimizer,
    *,
    n_sliders: int,
    optimizer_name: str = "adamw",
    max_denoising_steps: int = 50,
    resolution=512,
    batch_size: int = 1,
    denoise_guidance: float = 3.0,
    compute_dtype=torch.bfloat16,
    remat: bool = True,
    mesh=None,
    is_xl: bool = False,
    chunk: int = 1,
    shared_t_to: bool = False,
    t_to_mode: Optional[str] = None,
    t_to_strata: int = 8,
):
    """Build `step(state, unet_params, pairs, draws=None) -> (state, metrics)`.

    `state.lora` is a `stack_fleet` tree, `pairs` a `stack_fleet_pairs`
    dict on the UNet's device. `draws`, if given, is a list of K per-row
    draw tuples (pair index, t_to, latents[, crop[, ancestral noise]]) as
    `step_draws` makes them, with the mode's t_to, in place of
    `fleet_step_draws`. Per row the iteration is the solo step's
    (`text_slider.make_text_slider_step`); the K rows share each UNet call:
    the CFG-doubled [uncond K*B, cond K*B] denoise rows, one 3*K*B-row
    frozen pass with the slider off, one K*B-row grad pass at multiplier 1
    with the (K, ...) leaves repeated B times. The loss is the sum over rows
    of each row's own mean, so no row's gradient is scaled by K. The step
    updates `state` in place and returns it with per-row metrics (lists of
    K): loss, t_to, pair, grad_norm (each row's own norm); `loop`, the
    denoise loop's length max(t_to); and on CUDA phase_ms as the solo step
    gives it. It runs under `deterministic_cudnn` and `f16_sums_in_f32`.

    `t_to_mode` ("per_row" by default; `shared_t_to=True` means "shared"):
    the denoise loop runs to max_r(t_to_r), so the joint distribution sets
    its length while each row's training only needs the marginal. per_row
    keeps the solo streams, E[max of K] ~ (T-1)K/(K+1); shared gives every
    row row 0's draw, E[loop] = (T-1)/2, with every row's t_to the same;
    stratified correlates the rows only through a shared stratum of width
    (T-1)/S, E[loop] = (T-1)/S ((S-1)/2 + K/(K+1)) + 1."""
    if t_to_mode is None:
        t_to_mode = "shared" if shared_t_to else "per_row"
    elif shared_t_to and t_to_mode != "shared":
        raise ValueError(f"shared_t_to=True conflicts with t_to_mode={t_to_mode!r}")
    if t_to_mode not in T_TO_MODES:
        raise ValueError(f"t_to_mode must be per_row/shared/stratified, got {t_to_mode!r}")
    if t_to_mode == "stratified" and not 1 <= t_to_strata <= max_denoising_steps - 1:
        raise ValueError(f"t_to_strata={t_to_strata} must be in [1, {max_denoising_steps - 1}]")
    K_all = n_sliders
    K, r0 = _check_builder(optimizer, optimizer_name, mesh, chunk, K_all)
    B = batch_size
    KB = K * B
    ts1000, scale1000 = train_grid_tables(schedule, sampler.kind)
    grid_stride = schedule.num_train_timesteps // max_denoising_steps
    height, width = resolution if isinstance(resolution, tuple) else (resolution, resolution)
    latent_shape = (B, height // 8, width // 8, unet_cfg.in_channels)

    def unet(params, x, t, ehs, added, lora=None):
        return unet2d.apply(params, unet_cfg, x, t, ehs, added_cond=added, lora=lora,
                            remat=remat)

    def rep(e):
        """(K, ...) per slider -> (K * B, ...) per row, in the compute dtype."""
        return e.repeat_interleave(B, dim=0).to(compute_dtype)

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
        if draws is None:
            draws = fleet_step_draws(state.seed, state.step,
                                     [int(n) for n in pairs["n_pairs"]], max_denoising_steps,
                                     latent_shape, sampler.init_noise_sigma, mode=t_to_mode,
                                     strata=t_to_strata, crop=is_xl,
                                     ancestral=sampler.stochastic)
        if len(draws) != K_all:
            raise ValueError(f"{len(draws)} rows of draws for a fleet of {K_all}")
        all_idx, all_t_to = [int(d[0]) for d in draws], [int(d[1]) for d in draws]
        # this rank's rows of the draws and pairs (all of them without dp)
        draws = draws[r0:r0 + K]
        pairs = {k: v[r0:r0 + K] for k, v in pairs.items()}
        n_pairs = [int(n) for n in pairs["n_pairs"]]
        idx = [int(d[0]) for d in draws]
        t_to = [int(d[1]) for d in draws]
        for r in range(K):
            if not (0 <= idx[r] < n_pairs[r] and 1 <= t_to[r] < max_denoising_steps):
                raise ValueError(f"row {r} draws out of range: pair {idx[r]} of {n_pairs[r]}, "
                                 f"t_to {t_to[r]}")
            if sampler.stochastic and (len(draws[r]) < 5 or draws[r][4] is None
                                       or len(draws[r][4]) < t_to[r]):
                raise ValueError(f"row {r}: the {sampler.kind} denoise loop needs {t_to[r]} "
                                 "ancestral draws")
        rows = torch.arange(K, device=device)
        pair = {k: v[rows, torch.tensor(idx, device=device)] for k, v in pairs.items()
                if k != "n_pairs"}
        if is_xl and "dynamic_crops" in pair:
            ids = []
            for r in range(K):
                crop = draws[r][3] if len(draws[r]) > 3 else None
                if float(pair["dynamic_crops"][r]) > 0:
                    if crop is None:
                        raise ValueError("an SDXL pair with dynamic_crops needs the crop draws")
                    ids.append(get_add_time_ids(height, width, dynamic_crops=True,
                                                draws=crop)[0].to(device, pair["time_ids"].dtype))
                else:
                    ids.append(pair["time_ids"][r])
            pair["time_ids"] = torch.stack(ids)
        timer = _PhaseTimer(device)
        timer.mark("start")
        loop = max(t_to)

        # 2. partial denoise to max(t_to), slider ON, rows past their t_to frozen
        with torch.no_grad():
            x = torch.cat([torch.as_tensor(d[2]) for d in draws]).to(device=device,
                                                                     dtype=compute_dtype)
            lora_on = SliderLora(weights=_tile_tree(_repeat_rows(state.lora, B), 2),
                                 multiplier=1.0)
            ehs_cfg = torch.cat([rep(pair["unconditional"]), rep(pair["target"])])
            added_cfg = added_concat(added_from(pair, "unconditional"), added_from(pair, "target"))
            timesteps = sampler.timesteps.to(device)
            t_rows = torch.tensor(t_to, device=device).repeat_interleave(B)  # (K * B,)
            s_state = sampler.init_state(x)
            for i in range(loop):
                x_in = sampler.scale_model_input(torch.cat([x, x]), i).to(compute_dtype)
                eps = unet(unet_params, x_in, timesteps[i], ehs_cfg, added_cfg, lora=lora_on)
                eps_u, eps_c = eps.chunk(2)
                eps_g = eps_u + denoise_guidance * (eps_c - eps_u)
                noise = None
                if sampler.stochastic:
                    # row r's own draw; a frozen row's is discarded by the mask
                    noise = torch.cat([torch.as_tensor(d[4][i]) if i < t_to[r]
                                       else torch.zeros(latent_shape)
                                       for r, d in enumerate(draws)])
                x_new, s_new = sampler.step(i, eps_g, x, s_state, noise=noise)
                active = i < t_rows
                x = torch.where(active.reshape(KB, 1, 1, 1), x_new.to(compute_dtype), x)
                # every sampler-state leaf is (history, K * B, ...): masked on
                # its row axis by structure (at K * B == LMS_ORDER a shape
                # test would pick the history axis)
                s_state = {k: torch.where(active.reshape((1, KB) + (1,) * (v.ndim - 2)), v,
                                          s_state[k].to(v.dtype)) for k, v in s_new.items()}
            timer.mark("denoise")

            # 3. per-row jump onto the 1000-step grid (the scale in f32)
            t_idx = torch.tensor(t_to) * grid_stride
            t_cur = ts1000[t_idx].repeat_interleave(B).to(device)
            scale = scale1000[t_idx].repeat_interleave(B).to(device).reshape(KB, 1, 1, 1)
            x_scaled = (x.float() * scale).to(compute_dtype)

            # 4. frozen eps: one 3 * K * B-row pass, slider OFF
            ehs3 = torch.cat([rep(pair["positive"]), rep(pair["neutral"]),
                              rep(pair["unconditional"])])
            added3 = added_concat(*(added_from(pair, r)
                                    for r in ("positive", "neutral", "unconditional")))
            frozen = unet(unet_params, x_scaled.repeat(3, 1, 1, 1), t_cur.repeat(3), ehs3,
                          added3).float()
            eps_pos, eps_neu, eps_unc = frozen.chunk(3)
            g = pair["guidance_signed"].float().repeat_interleave(B).reshape(KB, 1, 1, 1)
            goal = eps_neu + g * (eps_pos - eps_unc)
            timer.mark("frozen")

        # 5 + 6. grad pass on the target prompts: per-row adapters, per-row loss
        leaves = lora_leaves(state.lora)
        eps_t = unet(unet_params, x_scaled, t_cur, rep(pair["target"]),
                     added_from(pair, "target"),
                     lora=SliderLora(weights=_repeat_rows(leaves, B), multiplier=1.0)).float()
        diff = eps_t - goal
        loss_vec = (diff * diff).reshape(K, -1).mean(dim=1)
        grads = _tp_whole(lora_grads(loss_vec.sum(), leaves), mesh)
        timer.mark("grad")
        optimizer.update(state.lora, grads, state.opt_state)
        state.step += 1
        timer.mark("update")
        metrics = {"loss": loss_vec.tolist(), "t_to": all_t_to, "pair": all_idx,
                   "grad_norm": _row_norms(grads, K), "loop": loop,
                   "phase_ms": timer.phase_ms()}
        return state, _gather_metrics(metrics, ("loss", "grad_norm"), mesh)

    return run_under(functools.partial(_fleet_step_flags, mesh), step)


def _tp_whole(grads: dict, mesh) -> dict:
    """A fleet gradient made whole over tp (the split modules' leaves
    summed); rows never exchange data over dp."""
    if mesh is None or mesh.size("tp") == 1:
        return grads
    return all_reduce_grads(grads, mesh, dp=False)


def _row_norms(grads: dict, K: int) -> list:
    """Each row's gradient norm over every leaf of its adapter."""
    sq = sum((g.float() ** 2).reshape(K, -1).sum(dim=1) for e in grads.values()
             for g in e.values())
    return torch.sqrt(sq).tolist()


# ---------------------------------------------------------------------------
# the image fleet step
# ---------------------------------------------------------------------------


def make_fleet_image_step(
    unet_cfg: unet2d.UNetConfig,
    vae_cfg: vae.VaeConfig,
    schedule: DiffusionSchedule,
    sampler: Sampler,
    optimizer: SliderOptimizer,
    *,
    n_sliders: int,
    optimizer_name: str = "adamw",
    max_denoising_steps: int = 50,
    compute_dtype=torch.bfloat16,
    remat: bool = True,
    is_xl: bool = False,
    mesh=None,
    chunk: int = 1,
):
    """Build `step(state, unet_params, vae_params, batch, draws=None) ->
    (state, metrics)`: K image sliders (`training/image_slider.py`, one
    fused +-s batch each) in one step, the concurrent form of the
    reference's --stylecheck loop.

    `batch` leaves carry a leading (K,) slider axis: images_high /
    images_low (K, B, H, W, 3) uint8 (or float in [-1, 1]), scale (K,),
    positive / neutral (K, L, D) [+ pooled_* (K, Dp), time_ids (K, 6)].
    The 2*K*B images go through one f32 VAE encode (rows [high, low], each
    slider-major); every row draws its own t_to, posterior eps and noise
    (`image_step_draws(fleet_row_seed(seed, r), step, ...)`, or `draws`, K
    such tuples), so there is no shared loop and no mask; one grad pass at
    per-row multipliers sign * scale; the loss of a slider is 2 * mean over
    its own rows (its solo loss), the step's the sum. Metrics are lists of
    K: loss, t_to, scale, grad_norm; on CUDA phase_ms as the solo step
    gives it. It runs under `deterministic_cudnn`. The step computes in
    `compute_dtype`, which `train_fleet_images` takes from the load dtype
    (f32 under fp16), as the JAX image CLI does."""
    K_all = n_sliders
    K, r0 = _check_builder(optimizer, optimizer_name, mesh, chunk, K_all)
    ts1000, scale1000 = train_grid_tables(schedule, sampler.kind)
    grid_stride = schedule.num_train_timesteps // max_denoising_steps

    def step(state: SliderTrainState, unet_params: dict, vae_params: dict, batch: dict,
             draws=None):
        device = batch["positive"].device
        if len(batch["images_high"]) != K_all:
            raise ValueError(f"{len(batch['images_high'])} rows of images for a fleet of {K_all}")
        if draws is not None and len(draws) != K_all:
            raise ValueError(f"{len(draws)} rows of draws for a fleet of {K_all}")
        # this rank's rows (all of them without dp)
        batch = {k: v[r0:r0 + K] for k, v in batch.items()}
        draws = None if draws is None else draws[r0:r0 + K]
        B = batch["images_high"].shape[1]
        KB = K * B
        timer = _PhaseTimer(device)
        timer.mark("start")

        def per_row(v):
            """(K,) per slider -> (2 * K * B,) per row."""
            return torch.as_tensor(v).repeat_interleave(B).repeat(2)

        def rep(e):
            return e.repeat_interleave(B, dim=0).to(compute_dtype)

        with torch.no_grad():
            high, low = batch["images_high"], batch["images_low"]
            imgs = torch.cat([high.reshape(KB, *high.shape[2:]),
                              low.reshape(KB, *low.shape[2:])]).to(device)
            if imgs.dtype == torch.uint8:
                imgs = imgs.float() / 127.5 - 1.0
            mean, logvar = vae.encode(vae_params, vae_cfg, imgs.float())
            if draws is None:
                draws = [image_step_draws(fleet_row_seed(state.seed, r), state.step,
                                          max_denoising_steps, (B, *mean.shape[1:]))
                         for r in range(r0, r0 + K)]
            t_to = [int(d[0]) for d in draws]
            if not all(1 <= t < max_denoising_steps - 1 for t in t_to):
                raise ValueError(f"t_to {t_to} out of [1, {max_denoising_steps - 1})")
            # each slider's posterior eps is [high B, low B], as its solo step's
            eps_post = [torch.as_tensor(d[1]) for d in draws]
            eps_all = torch.cat([e[:B] for e in eps_post] + [e[B:] for e in eps_post])
            lat = vae.normalize_latents(vae_cfg,
                                        vae.sample_latents(mean, logvar, eps=eps_all.to(device)))
            noise1 = torch.cat([torch.as_tensor(d[2]) for d in draws]).to(device=device,
                                                                          dtype=lat.dtype)
            noise = torch.cat([noise1, noise1])  # the same noise for +-s
            # the 50-grid timestep (the reference's quirk), truncated to an integer
            t_add = per_row(sampler.timesteps[torch.tensor(t_to)].to(torch.int32)).to(device)
            noisy = schedule.add_noise(lat, noise, t_add)
            t_idx = torch.tensor(t_to) * grid_stride
            t_cur = per_row(ts1000[t_idx]).to(device)
            x_in = (noisy * per_row(scale1000[t_idx]).to(device).reshape(-1, 1, 1, 1)).to(
                compute_dtype)
            ehs = torch.cat([rep(batch["positive"]), rep(batch["neutral"])])
            added = None
            if is_xl:
                added = {"text_embeds": torch.cat([rep(batch["pooled_positive"]),
                                                   rep(batch["pooled_neutral"])]),
                         "time_ids": rep(batch["time_ids"]).repeat(2, 1)}
            s = torch.as_tensor(batch["scale"], dtype=torch.float32).cpu()
            mult = torch.cat([torch.ones(KB), -torch.ones(KB)]) * per_row(s)
            timer.mark("encode")

        leaves = lora_leaves(state.lora)
        eps = unet2d.apply(unet_params, unet_cfg, x_in, t_cur, ehs, added_cond=added,
                           lora=SliderLora(weights=_tile_tree(_repeat_rows(leaves, B), 2),
                                           multiplier=mult.to(device)),
                           remat=remat).float()
        diff = eps - noise
        loss_vec = 2.0 * (diff * diff).reshape(2, K, -1).mean(dim=(0, 2))
        grads = _tp_whole(lora_grads(loss_vec.sum(), leaves), mesh)
        timer.mark("grad")
        optimizer.update(state.lora, grads, state.opt_state)
        state.step += 1
        timer.mark("update")
        metrics = {"loss": loss_vec.tolist(), "t_to": t_to, "scale": s.tolist(),
                   "grad_norm": _row_norms(grads, K), "phase_ms": timer.phase_ms()}
        return state, _gather_metrics(metrics, ("loss", "t_to", "scale", "grad_norm"), mesh)

    return run_under(functools.partial(_fleet_step_flags, mesh), step)


# ---------------------------------------------------------------------------
# the host drivers
# ---------------------------------------------------------------------------


def _fleet_loras(config, models, seed: int, rows: range, device, mesh=None, **init) -> dict:
    """The stacked initial LoRA of fleet rows `rows`: row r's is the solo
    run's of seed `fleet_row_seed(seed, r)` (drawn from that seed + 1)."""
    return stack_fleet([draw_unet_lora(config, models, fleet_row_seed(seed, r), device, mesh,
                                       **init) for r in rows])


def _local_rows(K: int, mesh) -> range:
    """The fleet rows this rank trains: its dp share of range(K)."""
    if mesh is None:
        return range(K)
    if K % mesh.size("dp"):
        raise ValueError(f"fleet size {K} must divide over dp={mesh.size('dp')}")
    n = K // mesh.size("dp")
    return range(mesh.coord("dp") * n, (mesh.coord("dp") + 1) * n)


def _whole_fleet(lora: dict, mesh) -> dict:
    """The fleet's K rows from every rank's share (a gather over dp; every
    rank takes part)."""
    if mesh is None or mesh.size("dp") == 1:
        return lora
    return {m: {k: all_gather_rows(t, mesh) for k, t in e.items()} for m, e in lora.items()}


def _save_all(save_dir: Path, names: list, lora: dict, suffix: str, ext: str, dtype,
              mesh=None) -> None:
    """Every row's slider file, written by the main rank from the whole
    fleet (every rank takes part in the gather)."""
    lora = _whole_fleet(lora, mesh)
    if mesh is not None and not mesh.is_main:
        return
    for name, solo in zip(names, unstack_fleet(lora)):
        lora_io.save_slider(str(save_dir / f"{name}{suffix}{ext}"), solo, dtype=dtype)


def _cpu_rows(lora: dict) -> list:
    return [{m: {k: t.detach().cpu().clone() for k, t in e.items()} for m, e in row.items()}
            for row in unstack_fleet(lora)]


def train_fleet(
    config,
    prompt_sets: "list[tuple[str, list]]",
    models,
    *,
    resume_from: Optional[str] = None,
    seed: int = 0,
    on_step=None,
    shared_t_to: bool = False,
    t_to_mode: Optional[str] = None,
    t_to_strata: int = 8,
    mesh=None,
) -> list:
    """Train len(prompt_sets) text sliders at once on the device of the
    UNet's parameters; returns their final LoRAs on the CPU, in input order.
    `prompt_sets` is [(slider name, [PromptSettings])]; `on_step(step,
    state, metrics)` is called after every iteration.

    Against the solo driver (`driver.train_text_sliders`): one (resolution,
    batch) bucket over all sliders (the rows share each UNet call), no
    dynamic_resolution, and an element-local optimizer. Writes
    `{save.name}_fleet_metadata.json` (sliders, prompts, config), each
    slider's `{name}_{i}steps{ext}` at the solo driver's steps and
    `{name}_last{ext}`, and the train state `{save.name}_fleet_trainstate.pt`
    every `tpu.state_checkpoint_every` iterations, from which
    `resume_from` continues.

    Under a process mesh (`mesh=`) each rank trains its dp share of the K
    rows (their adapters and optimizer states), with no gradient
    collective; the main rank writes every row's files, the file set of
    the dp = 1 run, and the train state is `{save.name}_fleet_trainstate.dcp`
    (`training/checkpoint.py`), from which a run on another dp resumes."""
    _note_text_loop_only(config)
    refuse_global_optimizer(config.train.optimizer)
    tpu = config.tpu
    device = _param_device(models.unet_params)
    save_dir = Path(config.save.path)
    ext = ".safetensors" if config.save.format == "safetensors" else ".pt"
    names = [n for n, _ in prompt_sets]
    K = len(prompt_sets)

    buckets = {(s.resolution, s.batch_size) for _, settings in prompt_sets for s in settings}
    if len(buckets) != 1:
        raise ValueError(f"fleet training needs ONE (resolution, batch) bucket, got {buckets}")
    if any(s.dynamic_resolution for _, ss in prompt_sets for s in ss):
        raise ValueError("fleet training does not support dynamic_resolution")
    (resolution, batch), = buckets

    cache = PromptEmbedsCache(models)
    schedule = make_schedule(
        prediction_type="v_prediction" if config.pretrained_model.v_pred else "epsilon")
    sampler = make_sampler(schedule, config.train.noise_scheduler,
                           config.train.max_denoising_steps)
    rows = _local_rows(K, mesh)
    fleet_lora = _fleet_loras(config, models, seed, rows, device, mesh)
    print(f"fleet: {K} sliders x {len(fleet_lora)} LoRA modules")
    optimizer = _slider_optimizer(config, lnet.trainable_mask(fleet_lora))
    pairs = stack_fleet_pairs([build_pairs(settings, cache, models.is_xl)
                               for _, settings in prompt_sets])
    step_fn = make_fleet_text_step(
        models.unet_config, schedule, sampler, optimizer, n_sliders=K,
        optimizer_name=config.train.optimizer,
        max_denoising_steps=config.train.max_denoising_steps, resolution=resolution,
        batch_size=batch * max(tpu.per_device_batch, 1), compute_dtype=compute_dtype_of(config),
        remat=tpu.remat, is_xl=models.is_xl, shared_t_to=shared_t_to, t_to_mode=t_to_mode,
        t_to_strata=t_to_strata, mesh=mesh)

    state = SliderTrainState.create(seed, fleet_lora, optimizer)
    if resume_from is not None:
        state = load_train_state(resume_from, device, template=state, mesh=mesh,
                                 rows=(rows.start, rows.stop))
        print(f"fleet resumed from {resume_from} at step {state.step}")

    main = mesh is None or mesh.is_main
    if main:
        save_dir.mkdir(parents=True, exist_ok=True)
        with open(save_dir / f"{config.save.name}_fleet_metadata.json", "w") as f:
            json.dump({"sliders": names,
                       "prompts": {n: [p.to_dict() for p in ss] for n, ss in prompt_sets},
                       "config": to_dict(config)}, f, indent=2)
    _note_steps_per_call(config)
    save_dtype = lora_io.torch_precision(config.save.precision)

    t_last = time.perf_counter()
    for sj in range(state.step, config.train.iterations):
        state, m = step_fn(state, models.unet_params, pairs)
        loss = np.asarray(m["loss"])
        if tpu.nan_check and not np.all(np.isfinite(loss)):
            raise FloatingPointError(f"non-finite fleet loss at step {sj}: {loss}")
        if sj % config.logging.log_every == 0 or sj == config.train.iterations - 1:
            dt = time.perf_counter() - t_last
            t_last = time.perf_counter()
            print(f"fleet step {sj}: mean loss*1k={float(loss.mean()) * 1000:.4f} "
                  f"({K} sliders, {dt:.2f}s since last log)")
        if on_step is not None:
            on_step(sj, state, m)
        if _save_due(sj, config.save.per_steps, config.train.iterations):
            print("Saving...")
            _save_all(save_dir, names, state.lora, f"_{sj}steps", ext, save_dtype, mesh)
        if tpu.state_checkpoint_every and sj % tpu.state_checkpoint_every == 0 and sj != 0:
            save_train_state(save_dir / f"{config.save.name}_fleet_trainstate", state, mesh,
                             row_sharded=True)

    print("Saving...")
    _save_all(save_dir, names, state.lora, "_last", ext, save_dtype, mesh)
    print("Done.")
    return _cpu_rows(_whole_fleet(state.lora, mesh))


def train_fleet_images(
    config,
    prompts: list,
    models,
    fleet_mains: "list[tuple[str, str]]",
    folders: list,
    scales: list,
    resolution: int,
    *,
    seed: int = 0,
    on_step=None,
    mesh=None,
) -> list:
    """One image slider per (name, folder_main) entry, all in one step
    (`make_fleet_image_step`): the fleet path of the reference's
    --stylecheck loop (the JAX CLI's `train_fleet_images`). The first
    prompt set's positive and neutral embeddings serve every slider; one
    `numpy.random.default_rng(seed)` draws each iteration's pairs, one per
    slider in order, as the JAX loop does. Every slider saves
    `{name}_{i}steps{ext}` at the solo CLI's steps and `{name}_last{ext}`.
    Returns the final LoRAs on the CPU in input order; `on_step(step,
    state, metrics)` is called after every iteration, the metrics with
    `read_s`, the host seconds of the K pairs' decode and resize. Under a
    process mesh each rank trains its dp share of the rows, as in
    `train_fleet`; every rank reads every pair, so the host stream is the
    dp = 1 run's."""
    _note_text_loop_only(config)
    _note_f32_under_fp16(config, "image fleet training")
    refuse_global_optimizer(config.train.optimizer)
    if models.vae_params is None:
        raise ValueError("image sliders encode their images: load the models with load_vae=True")
    device = _param_device(models.unet_params)
    K = len(fleet_mains)
    names = [n for n, _ in fleet_mains]
    datasets = [PairedImageFolders(main, folders, scales) for _, main in fleet_mains]
    cache = PromptEmbedsCache(models)
    settings = prompts[0]

    schedule = make_schedule(
        prediction_type="v_prediction" if config.pretrained_model.v_pred else "epsilon")
    sampler = make_sampler(schedule, config.train.noise_scheduler,
                           config.train.max_denoising_steps)
    # image sliders use kaiming a = sqrt(5) down-init (imagesliders/lora.py:96)
    fleet_lora = _fleet_loras(config, models, seed, _local_rows(K, mesh), device, mesh,
                              init_a=math.sqrt(5))
    print(f"fleet: {K} image sliders x {len(fleet_lora)} LoRA modules")
    optimizer = _slider_optimizer(config, lnet.trainable_mask(fleet_lora))
    _note_steps_per_call(config)
    step = make_fleet_image_step(
        models.unet_config, models.vae_config, schedule, sampler, optimizer, n_sliders=K,
        optimizer_name=config.train.optimizer,
        max_denoising_steps=config.train.max_denoising_steps,
        compute_dtype=load_dtype_of(config), remat=config.tpu.remat, is_xl=models.is_xl,
        mesh=mesh)
    state = SliderTrainState.create(seed, fleet_lora, optimizer)

    batch_static = {}
    for role, prompt in (("positive", settings.positive), ("neutral", settings.neutral)):
        e = cache[prompt]
        if models.is_xl:
            batch_static[role] = e[0].expand(K, *e[0].shape)
            batch_static[f"pooled_{role}"] = e[1].expand(K, *e[1].shape)
        else:
            batch_static[role] = e.expand(K, *e.shape)
    if models.is_xl:
        tid = get_add_time_ids(resolution, resolution)[0].to(device)
        batch_static["time_ids"] = tid.expand(K, *tid.shape)

    host_rng = np.random.default_rng(seed)
    save_dir = Path(config.save.path)
    if mesh is None or mesh.is_main:
        save_dir.mkdir(parents=True, exist_ok=True)
    ext = ".safetensors" if config.save.format == "safetensors" else ".pt"
    iterations, per = config.train.iterations, config.save.per_steps
    for sj in range(iterations):
        t_read = time.perf_counter()
        drawn = [ds.sample_pair(host_rng, resolution) for ds in datasets]
        read_s = time.perf_counter() - t_read
        batch = dict(
            batch_static, scale=torch.tensor([s for s, _, _ in drawn], dtype=torch.float32),
            images_low=torch.from_numpy(np.stack([to_u8(lo)[None] for _, lo, _ in drawn])
                                        ).to(device),
            images_high=torch.from_numpy(np.stack([to_u8(hi)[None] for _, _, hi in drawn])
                                         ).to(device))
        state, m = step(state, models.unet_params, models.vae_params, batch)
        m["read_s"] = read_s
        if sj % config.logging.log_every == 0:
            print(f"fleet step {sj}: mean loss*1k={float(np.mean(m['loss'])) * 1000:.4f} "
                  f"({K} image sliders)")
        if on_step is not None:
            on_step(sj, state, m)
        if _save_due(sj, per, iterations):
            print("Saving...")
            _save_all(save_dir, names, state.lora, f"_{sj}steps", ext, torch.float32, mesh)
    print("Saving...")
    _save_all(save_dir, names, state.lora, "_last", ext, torch.float32, mesh)
    print("Done.")
    return _cpu_rows(_whole_fleet(state.lora, mesh))
