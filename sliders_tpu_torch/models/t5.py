"""T5 encoder (T5-v1.1 / FLUX's text_encoder_2) as a function over a
parameter dict (port of sliders_tpu/models/t5.py).

The FLUX pipeline encodes prompts with its last hidden state over 512 tokens
(custom_flux_pipeline.py:201-287). The parameter dict mirrors the
transformers state dict (shared / encoder.block.N.layer.{0,1} /
encoder.final_layer_norm, the relative position bias on block 0) in torch
layouts, so a snapshot loads with no transposes.

Numerics as in the JAX package: RMSNorm statistics in f32, the normalised
value cast to the weight dtype before the scale; T5 does not scale its
logits, so q is multiplied by sqrt(d_kv) in the activation dtype and the
attention divides it out again; gated GELU with the tanh approximation. The
relative position bias is an additive mask, so T5's attention takes the
plain path, never a kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from sliders_tpu_torch.models.params import ParamFactory
from sliders_tpu_torch.ops.attention import multihead_attention
from sliders_tpu_torch.ops.basic import gelu_tanh, linear


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6


T5_XXL = T5Config()
TINY = T5Config(vocab_size=100, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4)


def rms_norm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    w = p["weight"]
    return (xf * torch.rsqrt(var + eps)).to(w.dtype) * w


def _relative_position_bucket(relative_position: np.ndarray, num_buckets: int = 32,
                              max_distance: int = 128) -> np.ndarray:
    """T5's bidirectional bucketing (host numpy: fixed per sequence length)."""
    num_buckets //= 2
    ret = (relative_position > 0).astype(np.int64) * num_buckets
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        np.log(n.clip(1) / max_exact) / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int64)
    val_large = np.minimum(val_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_large)


def position_bias(params: dict, cfg: T5Config, length: int) -> torch.Tensor:
    """(1, heads, L, L) additive bias from block 0's relative embedding."""
    ctx = np.arange(length)[:, None]
    mem = np.arange(length)[None, :]
    buckets = _relative_position_bucket(mem - ctx, cfg.relative_attention_num_buckets,
                                        cfg.relative_attention_max_distance)
    table = params["encoder"]["block"]["0"]["layer"]["0"]["SelfAttention"][
        "relative_attention_bias"]["weight"]  # (num_buckets, heads)
    bias = table[torch.as_tensor(buckets, device=table.device)]  # (L, L, heads)
    return bias.permute(2, 0, 1)[None]


def apply(params: dict, input_ids: torch.Tensor, cfg: T5Config,
          attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The encoder's last hidden state (B, L, d_model) in the weights' dtype."""
    enc = params["encoder"]
    x = params["shared"]["weight"][input_ids]
    bias = position_bias(params, cfg, input_ids.shape[1])
    if attention_mask is not None:
        neg = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9)
        bias = bias + neg.to(bias.device)
    for i in range(cfg.num_layers):
        blk = enc["block"][str(i)]["layer"]
        a = blk["0"]
        h = rms_norm(a["layer_norm"], x, cfg.layer_norm_eps)
        sa = a["SelfAttention"]
        q = linear(sa["q"], h) * torch.sqrt(torch.tensor(float(cfg.d_kv))).to(h.dtype)
        att = multihead_attention(q, linear(sa["k"], h), linear(sa["v"], h), cfg.num_heads,
                                  mask=bias)
        x = x + linear(sa["o"], att)
        m = blk["1"]
        h = rms_norm(m["layer_norm"], x, cfg.layer_norm_eps)
        ff = m["DenseReluDense"]
        h = gelu_tanh(linear(ff["wi_0"], h)) * linear(ff["wi_1"], h)
        x = x + linear(ff["wo"], h)
    return rms_norm(enc["final_layer_norm"], x, cfg.layer_norm_eps)


def init_params(generator: Optional[torch.Generator], cfg: T5Config, dtype=torch.float32,
                device="cpu") -> dict:
    """Random init with the JAX package's distributions: linears normal *
    fan_in^-1/2 without bias, the embedding and the position table normal *
    0.02, unit norms. Each leaf is drawn in `dtype` on `device`."""
    f = ParamFactory(generator, dtype, device)
    inner = cfg.num_heads * cfg.d_kv

    def dense(i, o):
        return f.dense(i, o, bias=False)

    def rn(d):
        return {"weight": f.const((d,), 1.0)}

    blocks = {}
    for i in range(cfg.num_layers):
        sa = {"q": dense(cfg.d_model, inner), "k": dense(cfg.d_model, inner),
              "v": dense(cfg.d_model, inner), "o": dense(inner, cfg.d_model)}
        if i == 0:
            sa["relative_attention_bias"] = {
                "weight": f.normal((cfg.relative_attention_num_buckets, cfg.num_heads), 0.02)}
        blocks[str(i)] = {"layer": {
            "0": {"SelfAttention": sa, "layer_norm": rn(cfg.d_model)},
            "1": {"DenseReluDense": {"wi_0": dense(cfg.d_model, cfg.d_ff),
                                     "wi_1": dense(cfg.d_model, cfg.d_ff),
                                     "wo": dense(cfg.d_ff, cfg.d_model)},
                  "layer_norm": rn(cfg.d_model)},
        }}
    return {
        "shared": {"weight": f.normal((cfg.vocab_size, cfg.d_model), 0.02)},
        "encoder": {"block": blocks, "final_layer_norm": rn(cfg.d_model)},
    }
