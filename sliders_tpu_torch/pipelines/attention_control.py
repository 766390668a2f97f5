"""Prompt-to-prompt attention control: attention-map extraction and
word-index aggregation (port of sliders_tpu/pipelines/attention_control.py;
the reference's controller rewiring and map utilities,
trainscripts/textsliders/ptp_utils.py:173-240 register_attention_control,
:243-295 aggregate_attention / show_cross_attention).

The reference monkey-patches CrossAttention.forward to route the
probabilities through a mutable controller. Here the tap is a context
(`ops/attention.AttentionTap`): one UNet forward runs under it and returns
every wanted call site's probabilities beside the noise prediction. A
tapped call runs the plain attention path (it materialises the
probabilities); every other call keeps its kernel route.

Store keys are the UNet's call-site paths ("down_blocks.0.attentions.0.
transformer_blocks.0.attn1", ...), in call order; `group_store` regroups
them into the reference's AttentionStore lists "{down|mid|up}_{cross|self}".
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sliders_tpu_torch.models import unet2d
from sliders_tpu_torch.ops.attention import AttentionTap


def place_in_unet(path: str) -> str:
    """'down' / 'mid' / 'up' from a call-site path (ptp_utils.py:220-231)."""
    if path.startswith("down_blocks"):
        return "down"
    if path.startswith("mid_block"):
        return "mid"
    if path.startswith("up_blocks"):
        return "up"
    raise ValueError(f"not a UNet attention path: {path}")


def is_cross(path: str) -> bool:
    return path.endswith("attn2")


def group_store(raw: dict) -> dict:
    """{path: probs} -> the reference AttentionStore layout {'down_cross':
    [...], 'down_self': [...], 'mid_cross': ..., ...}, in call order
    (ptp_utils.py AttentionStore.get_empty_store)."""
    out = {f"{p}_{c}": [] for p in ("down", "mid", "up") for c in ("cross", "self")}
    for path, probs in raw.items():  # dicts keep call order
        out[f"{place_in_unet(path)}_{'cross' if is_cross(path) else 'self'}"].append(probs)
    return out


def make_attention_maps_fn(unet_cfg: unet2d.UNetConfig, *, compute_dtype=torch.float32,
                           attn_filter=None):
    """Build fn(params, latents, t, ehs, added_cond=None, lora=None) ->
    (eps, {path: probs}): one UNet forward under an `AttentionTap` (wanting
    the paths `attn_filter` accepts, every attention without one) that also
    returns each tapped call's softmax probabilities (B, H, Lq, Lkv). Runs
    under torch.inference_mode()."""

    @torch.inference_mode()
    def fn(params, latents, t, ehs, added_cond: Optional[dict] = None, lora=None):
        with AttentionTap(filter_fn=attn_filter) as tap:
            eps = unet2d.apply(params, unet_cfg, latents.to(compute_dtype), t,
                               ehs.to(compute_dtype), added_cond=added_cond, lora=lora)
        return eps, dict(tap.store)

    return fn


def aggregate_attention(store: dict, res: int, from_where: tuple = ("up", "down"),
                        is_cross: bool = True, select: int = 0) -> np.ndarray:
    """The mean (res, res) attention map over the chosen UNet places
    (ptp_utils.aggregate_attention, :243-259): the maps whose query length
    is res**2, reshaped to (H, res, res, Lkv), averaged over layers and
    heads. `store` is the `group_store` layout; `select` picks the batch
    row. Returns (res, res, Lkv) float32."""
    out = []
    for place in from_where:
        for item in store[f"{place}_{'cross' if is_cross else 'self'}"]:
            a = torch.as_tensor(item).float().cpu().numpy()  # (B, H, Lq, Lkv)
            if a.shape[2] == res * res:
                out.append(a[select].reshape(-1, res, res, a.shape[3]))
    if not out:
        raise ValueError(f"no attention maps at res {res} in {from_where}")
    return np.concatenate(out, axis=0).mean(axis=0)


def word_attention_maps(tokenizer, prompt: str, agg: np.ndarray,
                        normalize: bool = True) -> dict[str, np.ndarray]:
    """Per-word spatial cross-attention maps, the reference's
    show_cross_attention indexing (ptp_utils.py:262-295): each token
    position of the prompt (bos, its words, eos) decoded and its column of
    the aggregated map sliced, min-max normalised. Returns
    {"pos:token": (res, res)}."""
    ids = [int(tokenizer.bos_token_id)] + tokenizer.tokenize(prompt) + [
        int(tokenizer.eos_token_id)]
    inv = {v: k for k, v in tokenizer.vocab.items()}
    inv.update({v: k for k, v in getattr(tokenizer, "added_tokens", {}).items()})
    out: dict[str, np.ndarray] = {}
    for pos, tid in enumerate(ids):
        if pos >= agg.shape[-1]:
            break
        m = agg[..., pos]
        if normalize and m.max() > m.min():
            m = (m - m.min()) / (m.max() - m.min())
        out[f"{pos}:{inv.get(tid, str(tid)).replace('</w>', '')}"] = m
    return out
