"""Optimizers and LR schedules for slider training
(port of sliders_tpu/training/optimizers.py).

Name-compatible with the reference factories (train_util.py:336-404) as the
JAX package exposes them: LR schedules constant / cosine /
cosine_with_restarts / step / linear with the torch scheduler semantics the
reference relies on (ConstantLR factor 1, CosineAnnealingLR eta_min=lr/100,
CosineAnnealingWarmRestarts T_0=iters/10 T_mult=2, StepLR step=iters/100
gamma=0.999, LinearLR factor 0.5 over iters/100), and optimizers adamw
(weight decay 1e-2, torch's default), adam and lion. The `*8bit` names map
to their full-precision optimizer with a warning, as in the JAX package.
prodigy and the D-Adaptation optimizers are not ported (ROADMAP queue 1,
item 17).

`SliderOptimizer` runs on a LoRA tree ({module: {'down', 'up', 'alpha'}})
and does optax's arithmetic in the same order (`scale_by_adam` or
`scale_by_lion`, then the decoupled weight decay, then -lr(count)), with the
lr of update `count` taken at the number of updates made before it, as optax
counts. Leaves the trainable mask marks False (the alphas) are never
written, so they stay bit for bit as they were. Updates happen in place.
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
    """adamw / adam / lion over a LoRA tree, with optax's update arithmetic.

    `init(weights)` returns the state ({'count', 'mu'[, 'nu']}, tensors on
    the weights' devices); `update(weights, grads, state)` applies one step
    in place to `weights` and `state`."""

    def __init__(self, kind: str, lr_schedule: Callable[[int], float], hyper: dict,
                 trainable_mask: Optional[dict] = None):
        self.kind = kind
        self.lr_schedule = lr_schedule
        self.hyper = hyper
        self.trainable_mask = trainable_mask

    def _trainable(self, module: str, leaf: str) -> bool:
        return self.trainable_mask is None or self.trainable_mask[module][leaf]

    def init(self, weights: dict) -> dict:
        def zeros():
            return {m: {k: torch.zeros_like(t, dtype=torch.float32) for k, t in e.items()
                        if self._trainable(m, k)} for m, e in weights.items()}

        state = {"count": 0, "mu": zeros()}
        if self.kind != "lion":
            state["nu"] = zeros()
        return state

    @torch.no_grad()
    def update(self, weights: dict, grads: dict, state: dict) -> None:
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


def make_optimizer(
    name: str,
    lr_schedule: Callable[[int], float],
    optimizer_kwargs: Optional[dict] = None,
    trainable_mask: Optional[dict] = None,
) -> SliderOptimizer:
    """The optimizer by its reference name, with optax's keyword names
    (b1, b2, eps, eps_root, weight_decay); `trainable_mask` freezes the
    leaves it marks False (the LoRA alphas)."""
    kw = dict(optimizer_kwargs or {})
    name = name.lower()
    if name.endswith("8bit"):
        base = name[: -len("8bit")].rstrip("_")
        warnings.warn(f"{name}: bitsandbytes is not used; using full-precision {base}")
        name = base
    if name in ("prodigy", "dadaptadam", "dadaptadamw", "dadaptlion"):
        raise NotImplementedError(
            f"the {name} optimizer is not ported yet (ROADMAP queue 1, item 17)")
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
