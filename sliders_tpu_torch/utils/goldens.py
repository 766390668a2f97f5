"""Self-recording numerical goldens for real-weight validation (port of
sliders_tpu/utils/goldens.py).

The first run on real weights RECORDS the UNet's eps prediction on a fixed
probe; every later run (new conversion code, refactors, dtype changes)
compares against the recording, so conversion or model regressions on real
checkpoints fail loudly. Shared by `cli/validate_real_weights.py` and its
dry-run test on synthetic snapshots.

The JAX package draws its probe from `jax.random.key(11 / 12 / 13)`, which
the port cannot draw. The port draws it from `numpy.random.default_rng`
with the same seeds and stores it in the golden `.npz` beside `eps`, so a
later run compares on the recorded inputs, whatever draws it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_PROBE_KEYS = ("x", "t", "ehs")
_ADDED_KEYS = ("text_embeds", "time_ids")


def fixed_unet_probe(cfg, spatial: int = 64, tokens: int = 77) -> dict:
    """Deterministic f32 probe inputs for an eps golden, as numpy arrays:
    NHWC latents `x` (seed 11), timestep `t` = 500, the text states `ehs`
    (seed 12) and, for a `text_time` UNet, the pooled `text_embeds` (seed
    13) and the static `time_ids` of a square of 8 x `spatial` pixels."""
    probe = {
        "x": np.random.default_rng(11).standard_normal(
            (1, spatial, spatial, cfg.in_channels), np.float32),
        "t": np.asarray([500.0], np.float32),
        "ehs": np.random.default_rng(12).standard_normal(
            (1, tokens, cfg.cross_attention_dim), np.float32),
    }
    if cfg.addition_embed_type == "text_time":
        pooled_dim = cfg.projection_class_embeddings_input_dim - 6 * cfg.addition_time_embed_dim
        px = spatial * 8
        probe["text_embeds"] = np.random.default_rng(13).standard_normal(
            (1, pooled_dim), np.float32)
        probe["time_ids"] = np.asarray([[px, px, 0, 0, px, px]], np.float32)
    return probe


def unet_on_probe(params: dict, cfg, probe: dict) -> torch.Tensor:
    """The UNet's eps on `probe`, on the parameters' device, in f32 inputs."""
    from sliders_tpu_torch.models import unet2d

    device = params["conv_in"]["weight"].device
    t = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in probe.items()}
    added = ({k: t[k] for k in _ADDED_KEYS}
             if cfg.addition_embed_type == "text_time" else None)
    with torch.inference_mode():
        return unet2d.apply(params, cfg, t["x"], t["t"], t["ehs"], added_cond=added)


def record_or_compare_eps_golden(models, golden_path: str, *, atol: float = 1e-3,
                                 spatial: int = 64) -> str:
    """Run the UNet on the fixed probe; record `golden_path` (eps and the
    probe) if absent and return 'recorded', else run it on the recorded
    probe and compare (returns 'matched' or raises AssertionError).

    Non-finite predictions always raise: a golden of NaNs would 'match'
    forever."""
    cfg = models.unet_config
    recorded = None
    if os.path.exists(golden_path):
        with np.load(golden_path) as f:
            recorded = dict(f)
        missing = [k for k in _PROBE_KEYS if k not in recorded]
        if missing:
            raise ValueError(f"{golden_path}: no probe inputs {missing} beside eps; the port "
                             "compares only on the inputs it recorded")
        probe = {k: v for k, v in recorded.items() if k != "eps"}
    else:
        probe = fixed_unet_probe(cfg, spatial=spatial)
    eps = unet_on_probe(models.unet_params, cfg, probe).float().cpu().numpy()
    if not np.isfinite(eps).all():
        raise AssertionError("UNet eps prediction contains non-finite values")
    if recorded is None:
        os.makedirs(os.path.dirname(golden_path) or ".", exist_ok=True)
        np.savez(golden_path, eps=eps, **probe)
        return "recorded"
    np.testing.assert_allclose(eps, recorded["eps"], atol=atol)
    return "matched"
