"""Optimizers and LR schedules for slider training
(port of sliders_tpu/training/optimizers.py).

Name-compatible with the reference factories (train_util.py:336-404) as the
JAX package exposes them: LR schedules constant / cosine /
cosine_with_restarts / step / linear with the torch scheduler semantics the
reference relies on (ConstantLR factor 1, CosineAnnealingLR eta_min=lr/100,
CosineAnnealingWarmRestarts T_0=iters/10 T_mult=2, StepLR step=iters/100
gamma=0.999, LinearLR factor 0.5 over iters/100), and optimizers adamw
(weight decay 1e-2, torch's default), adam and lion, and the adaptive ones:
prodigy (optax.contrib `prodigy`), dadaptadam / dadaptadamw (optax.contrib
`dadapt_adamw`) and dadaptlion, which warns and runs dadapt_adamw as the
JAX package does. The `*8bit` names map to their full-precision optimizer
with a warning, as in the JAX package.

`SliderOptimizer` runs on a LoRA tree ({module: {'down', 'up', 'alpha'}})
and does optax's arithmetic in the same order (`scale_by_adam` or
`scale_by_lion`, then the decoupled weight decay, then -lr(count); for the
adaptive kinds the update rules of optax.contrib 0.2.6 term by term), with
the lr of update `count` taken at the number of updates made before it, as
optax counts. Leaves the trainable mask marks False (the alphas) are never
written, so they stay bit for bit as they were; the adaptive kinds' global
sums (prodigy's <g, p0 - p> and sum |grad_sum|, D-Adapt's <g, s / (sqrt(v)
+ eps)> and its l1 norm) run over the trainable leaves only, as
`optax.masked` hands the inner transform only those. Updates happen in
place; the adaptive kinds keep their scalars (`estim_lr`,
`numerator_weighted`) as 0-d f32 tensors on the weights' device, so an
update never waits on the host.
"""

from __future__ import annotations

import ast
import math
import warnings
from typing import Callable, Optional

import torch

_ADAM_KEYS = ("b1", "b2", "eps", "eps_root")
_DEFAULTS = {
    "adamw": {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0, "weight_decay": 1e-2},
    "adam": {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0, "weight_decay": 0.0},
    "lion": {"b1": 0.9, "b2": 0.99, "weight_decay": 0.0},
}
_ACCEPTS = {"adamw": (*_ADAM_KEYS, "weight_decay"), "adam": _ADAM_KEYS,
            "lion": ("b1", "b2", "weight_decay")}
# optax.contrib's keyword names and defaults (beta3 None: sqrt(beta2))
_ADAPTIVE_DEFAULTS = {
    "prodigy": {"betas": (0.9, 0.999), "beta3": None, "eps": 1e-8, "estim_lr0": 1e-6,
                "estim_lr_coef": 1.0, "weight_decay": 0.0, "safeguard_warmup": False},
    "dadapt_adamw": {"betas": (0.9, 0.999), "eps": 1e-8, "estim_lr0": 1e-6,
                     "weight_decay": 0.0},
}
# reference name -> the update rule that runs it
ADAPTIVE_NAMES = {"prodigy": "prodigy", "dadaptadam": "dadapt_adamw",
                  "dadaptadamw": "dadapt_adamw", "dadaptlion": "dadapt_adamw"}


def make_lr_schedule(
    name: Optional[str], lr: float, max_iterations: int, lr_min: Optional[float] = None
) -> Callable[[int], float]:
    """step -> learning rate (a float) for update number `step` (from 0)."""
    lr_min = lr / 100 if lr_min is None else lr_min  # train_lora.py:94
    name = (name or "constant").lower()

    if name == "constant":
        return lambda step: lr

    if name == "cosine":
        def cosine(step):
            t = min(step, max_iterations)
            return lr_min + (lr - lr_min) * (1 + math.cos(math.pi * t / max_iterations)) / 2
        return cosine

    if name == "cosine_with_restarts":
        T0 = max(max_iterations // 10, 1)

        def restarts(step):
            # cycle n starts at T0 * (2^n - 1) and lasts T0 * 2^n (T_mult = 2)
            n = math.floor(math.log2(step / T0 + 1.0))
            t_cur = step - T0 * (2.0**n - 1.0)
            return lr_min + (lr - lr_min) * (1 + math.cos(math.pi * t_cur / (T0 * 2.0**n))) / 2
        return restarts

    if name == "step":
        size = max(max_iterations // 100, 1)
        return lambda step: lr * 0.999 ** (step // size)

    if name == "linear":
        total = max(max_iterations // 100, 1)
        return lambda step: lr * (0.5 + 0.5 * min(max(step / total, 0.0), 1.0))

    raise ValueError("Scheduler must be cosine, cosine_with_restarts, step, linear or constant")


class SliderOptimizer:
    """adamw / adam / lion / prodigy / dadapt_adamw over a LoRA tree, with
    optax's update arithmetic.

    `init(weights)` returns the state ({'count', 'mu'[, 'nu']} for the
    element-local kinds; {'count', 'exp_avg', 'exp_avg_sq', 'grad_sum'[,
    'params0'], 'estim_lr', 'numerator_weighted'} for the adaptive ones;
    tensors on the weights' devices, trees over the trainable leaves);
    `update(weights, grads, state)` applies one step in place to `weights`
    and `state`."""

    def __init__(self, kind: str, lr_schedule: Callable[[int], float], hyper: dict,
                 trainable_mask: Optional[dict] = None):
        self.kind = kind
        self.lr_schedule = lr_schedule
        self.hyper = hyper
        self.trainable_mask = trainable_mask

    @property
    def adaptive(self) -> bool:
        """True for the kinds that estimate one step size over the whole tree."""
        return self.kind in _ADAPTIVE_DEFAULTS

    def _trainable(self, module: str, leaf: str) -> bool:
        return self.trainable_mask is None or self.trainable_mask[module][leaf]

    def _leaves(self, tree: dict):
        """(module, leaf, tensor) of the trainable leaves, in tree order."""
        return [(m, k, t) for m, e in tree.items() for k, t in e.items() if self._trainable(m, k)]

    def init(self, weights: dict) -> dict:
        def zeros():
            out = {}
            for m, k, t in self._leaves(weights):
                out.setdefault(m, {})[k] = torch.zeros_like(t, dtype=torch.float32)
            return out

        if self.adaptive:
            leaves = self._leaves(weights)
            device = leaves[0][2].device if leaves else "cpu"
            state = {"count": 0, "exp_avg": zeros(), "exp_avg_sq": zeros(),
                     "grad_sum": zeros(),
                     "estim_lr": torch.tensor(self.hyper["estim_lr0"], dtype=torch.float32,
                                              device=device),
                     "numerator_weighted": torch.zeros((), dtype=torch.float32, device=device)}
            if self.kind == "prodigy":
                state["params0"] = {}
                for m, k, t in leaves:
                    state["params0"].setdefault(m, {})[k] = t.detach().float().clone()
            return state
        state = {"count": 0, "mu": zeros()}
        if self.kind != "lion":
            state["nu"] = zeros()
        return state

    @torch.no_grad()
    def update(self, weights: dict, grads: dict, state: dict) -> None:
        if self.kind == "prodigy":
            return self._prodigy(weights, grads, state)
        if self.kind == "dadapt_adamw":
            return self._dadapt_adamw(weights, grads, state)
        h = self.hyper
        b1, b2 = h["b1"], h["b2"]
        count = state["count"] + 1
        lr = float(self.lr_schedule(state["count"]))
        if self.kind != "lion":
            # optax's bias corrections, computed in f32 as optax computes them
            f32 = torch.tensor([b1, b2], dtype=torch.float32)
            bc1, bc2 = (1 - f32 ** count).tolist()
        for m, entry in weights.items():
            for k, p in entry.items():
                if not self._trainable(m, k):
                    continue
                g = grads[m][k].float()
                mu = state["mu"][m][k]
                if self.kind == "lion":
                    u = torch.sign((1.0 - b1) * g + b1 * mu)
                    mu.copy_((1.0 - b2) * g + b2 * mu)
                else:
                    nu = state["nu"][m][k]
                    mu.copy_((1.0 - b1) * g + b1 * mu)
                    nu.copy_((1.0 - b2) * (g * g) + b2 * nu)
                    u = (mu / bc1) / (torch.sqrt(nu / bc2 + h["eps_root"]) + h["eps"])
                if h["weight_decay"]:
                    u = u + h["weight_decay"] * p
                p.copy_(p + (-lr) * u)
        state["count"] = count

    def _scalars(self, state: dict, device):
        """(count + 1, the schedule's lr at count, optax's bias correction
        sqrt(1 - b2^(count + 1)) / (1 - b1^(count + 1))), as f32 tensors."""
        beta1, beta2 = self.hyper["betas"]
        count_inc = state["count"] + 1
        sched = torch.tensor(float(self.lr_schedule(state["count"])), dtype=torch.float32,
                             device=device)
        b = torch.tensor([beta1, beta2], dtype=torch.float32, device=device) ** float(count_inc)
        bc = ((1 - b[1]) ** 0.5) / (1 - b[0])
        return count_inc, sched, bc

    def _prodigy(self, weights: dict, grads: dict, state: dict) -> None:
        """optax.contrib.prodigy's update_fn, leaf by leaf (optax 0.2.6)."""
        h = self.hyper
        beta1, beta2 = h["betas"]
        beta3 = beta2 ** 0.5 if h["beta3"] is None else h["beta3"]
        estim_lr0, eps, wd = h["estim_lr0"], h["eps"], h["weight_decay"]
        leaves = self._leaves(weights)
        estim_lr = state["estim_lr"]
        count_inc, sched, bc = self._scalars(state, estim_lr.device)
        dlr = estim_lr * sched * bc
        dgs = [estim_lr * grads[m][k].float() for m, k, _ in leaves]
        numerator_acum = sum(torch.vdot(grads[m][k].float().reshape(-1),
                                        (state["params0"][m][k] - p).reshape(-1))
                             for m, k, p in leaves)
        grad_scale = estim_lr if h["safeguard_warmup"] else dlr
        for (m, k, _), dg in zip(leaves, dgs):
            ea, eas, sk = (state[n][m][k] for n in ("exp_avg", "exp_avg_sq", "grad_sum"))
            ea.copy_(beta1 * ea + (1 - beta1) * dg)
            eas.copy_(beta2 * eas + (1 - beta2) * dg * dg)
            sk.copy_(beta3 * sk + grad_scale * dg / estim_lr0)
        numerator_weighted = beta3 * state["numerator_weighted"]
        numerator_weighted = numerator_weighted + (estim_lr / estim_lr0) * dlr * numerator_acum
        denominator = sum(state["grad_sum"][m][k].abs().sum() for m, k, _ in leaves)
        lr_estimate = h["estim_lr_coef"] * numerator_weighted / denominator
        # torch.maximum keeps a NaN, as jnp.maximum does
        new_lr = torch.maximum(estim_lr, lr_estimate)
        for m, k, p in leaves:
            ea, eas = state["exp_avg"][m][k], state["exp_avg_sq"][m][k]
            p.copy_(p + (-wd * dlr * p - dlr * ea / (torch.sqrt(eas) + new_lr * eps)))
        state.update(estim_lr=new_lr, numerator_weighted=numerator_weighted, count=count_inc)

    def _dadapt_adamw(self, weights: dict, grads: dict, state: dict) -> None:
        """optax.contrib.dadapt_adamw's update_fn, leaf by leaf (optax 0.2.6)."""
        h = self.hyper
        beta1, beta2 = h["betas"]
        eps, wd = h["eps"], h["weight_decay"]
        sb2 = beta2 ** 0.5
        leaves = self._leaves(weights)
        estim_lr = state["estim_lr"]
        count_inc, sched, bc = self._scalars(state, estim_lr.device)
        dlr = estim_lr * sched * bc
        numerator_acum = sum(
            torch.vdot(grads[m][k].float().reshape(-1),
                       (state["grad_sum"][m][k]
                        / (torch.sqrt(state["exp_avg_sq"][m][k]) + eps)).reshape(-1))
            for m, k, _ in leaves)
        for m, k, _ in leaves:
            g = grads[m][k].float()
            ea, eas, sk = (state[n][m][k] for n in ("exp_avg", "exp_avg_sq", "grad_sum"))
            ea.copy_(beta1 * ea + (1 - beta1) * dlr * g)
            eas.copy_(beta2 * eas + (1 - beta2) * g * g)
            sk.copy_(sb2 * sk + (1 - sb2) * dlr * g)
        grad_sum_l1 = sum(state["grad_sum"][m][k].abs().sum() for m, k, _ in leaves)
        numerator_weighted = sb2 * state["numerator_weighted"] + (1 - sb2) * dlr * numerator_acum
        d_estimate = numerator_weighted / ((1 - sb2) * grad_sum_l1)
        new_lr = torch.maximum(estim_lr, d_estimate)
        for m, k, p in leaves:
            ea, eas = state["exp_avg"][m][k], state["exp_avg_sq"][m][k]
            p.copy_(p + (-wd * dlr * p - ea / (torch.sqrt(eas) + eps)))
        state.update(estim_lr=new_lr, numerator_weighted=numerator_weighted, count=count_inc)


def make_optimizer(
    name: str,
    lr_schedule: Callable[[int], float],
    optimizer_kwargs: Optional[dict] = None,
    trainable_mask: Optional[dict] = None,
) -> SliderOptimizer:
    """The optimizer by its reference name, with optax's keyword names
    (b1, b2, eps, eps_root, weight_decay; for prodigy betas, beta3, eps,
    estim_lr0, estim_lr_coef, weight_decay, safeguard_warmup; for the
    D-Adapt names betas, eps, estim_lr0, weight_decay); `trainable_mask`
    freezes the leaves it marks False (the LoRA alphas)."""
    kw = dict(optimizer_kwargs or {})
    name = name.lower()
    if name.endswith("8bit"):
        base = name[: -len("8bit")].rstrip("_")
        warnings.warn(f"{name}: bitsandbytes is not used; using full-precision {base}")
        name = base
    if name in ADAPTIVE_NAMES:
        if name == "dadaptlion":
            warnings.warn("dadaptlion: there is no D-Adapt Lion; using dadapt_adamw")
        kind = ADAPTIVE_NAMES[name]
        unknown = sorted(set(kw) - set(_ADAPTIVE_DEFAULTS[kind]))
        if unknown:
            raise TypeError(f"{name} got unexpected keyword arguments {unknown}")
        return SliderOptimizer(kind, lr_schedule, {**_ADAPTIVE_DEFAULTS[kind], **kw},
                               trainable_mask)
    if name not in _DEFAULTS:
        raise ValueError("Optimizer must be adam, adamw, lion or Prodigy")
    unknown = sorted(set(kw) - set(_ACCEPTS[name]))
    if unknown:
        raise TypeError(f"{name} got unexpected keyword arguments {unknown}")
    return SliderOptimizer(name, lr_schedule, {**_DEFAULTS[name], **kw}, trainable_mask)


def parse_optimizer_args(optimizer_args: str) -> dict:
    """Reference `k=v`-string parsing (train_lora.py:82-87)."""
    out = {}
    if optimizer_args:
        for arg in optimizer_args.split(" "):
            if not arg:
                continue
            key, value = arg.split("=")
            out[key] = ast.literal_eval(value)
    return out
