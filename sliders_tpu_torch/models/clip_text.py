"""CLIP text encoder (CLIP-L/14 for SD1 and SDXL, OpenCLIP bigG/14 with
its projection for SDXL's second encoder, the 23-layer OpenCLIP-H tower of
SD2.x) as a function over a parameter dict (port of
sliders_tpu/models/clip_text.py).

Output contract of the reference's `train_util.encode_prompts`: the last
hidden state after the final layer norm. The parameter dict mirrors the
transformers state dict (text_model.embeddings / encoder.layers.N /
final_layer_norm [+ text_projection]) in torch layouts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from sliders_tpu_torch.models.params import ParamFactory
from sliders_tpu_torch.ops.attention import causal_mask, multihead_attention
from sliders_tpu_torch.ops.basic import ACTIVATIONS, layer_norm, linear


@dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_positions: int = 77
    hidden_act: str = "quick_gelu"
    eos_token_id: int = 49407
    projection_dim: Optional[int] = None
    layer_norm_eps: float = 1e-5


CLIP_L = ClipTextConfig()  # SD1 / SDXL text_encoder
CLIP_SD2 = ClipTextConfig(
    hidden_size=1024, num_layers=23, num_heads=16, intermediate_size=4096,
    hidden_act="gelu",
)  # SD2.x text_encoder loaded with num_hidden_layers=23 (model_util.py:48)
CLIP_BIG_G = ClipTextConfig(
    hidden_size=1280, num_layers=32, num_heads=20, intermediate_size=5120,
    hidden_act="gelu", projection_dim=1280,
)  # SDXL text_encoder_2

TINY = ClipTextConfig(
    vocab_size=100, hidden_size=32, num_layers=2, num_heads=2,
    intermediate_size=64, max_positions=16, eos_token_id=99, projection_dim=24,
)


def _encoder_layer(p: dict, x, cfg: ClipTextConfig, mask):
    residual = x
    h = layer_norm(p["layer_norm1"], x, cfg.layer_norm_eps)
    attn = p["self_attn"]
    q = linear(attn["q_proj"], h)
    k = linear(attn["k_proj"], h)
    v = linear(attn["v_proj"], h)
    h = multihead_attention(q, k, v, cfg.num_heads, mask=mask)
    x = residual + linear(attn["out_proj"], h)

    residual = x
    h = layer_norm(p["layer_norm2"], x, cfg.layer_norm_eps)
    h = ACTIVATIONS[cfg.hidden_act](linear(p["mlp"]["fc1"], h))
    return residual + linear(p["mlp"]["fc2"], h)


def apply(
    params: dict,
    input_ids: torch.Tensor,
    cfg: ClipTextConfig,
    *,
    num_layers: Optional[int] = None,
) -> dict:
    """Run the text encoder on (B, L) token ids, in f32 whatever the weights'
    dtype (the JAX package's default).

    Returns {'last_hidden_state', 'hidden_states' (embeddings + each layer),
    'pooler_output', 'text_embeds' (if projection)}. `num_layers` truncates
    the stack (clip_skip); final_layer_norm still applies on top."""
    tm = params["text_model"]
    emb = tm["embeddings"]
    B, L = input_ids.shape
    x = emb["token_embedding"]["weight"][input_ids].float()
    x = x + emb["position_embedding"]["weight"][:L].float()

    mask = causal_mask(L, device=x.device)
    n = num_layers if num_layers is not None else cfg.num_layers
    hidden_states = [x]
    for i in range(n):
        x = _encoder_layer(tm["encoder"]["layers"][str(i)], x, cfg, mask)
        hidden_states.append(x)
    last = layer_norm(tm["final_layer_norm"], x, cfg.layer_norm_eps)

    # pooled = hidden state at the first EOS position (transformers semantics)
    eos_pos = torch.argmax((input_ids == cfg.eos_token_id).to(torch.int32), dim=-1)
    pooled = last[torch.arange(B, device=last.device), eos_pos]
    out = {
        "last_hidden_state": last,
        "hidden_states": tuple(hidden_states),
        "pooler_output": pooled,
    }
    if cfg.projection_dim is not None and "text_projection" in params:
        out["text_embeds"] = linear(params["text_projection"], pooled)
    return out


def init_params(
    generator: Optional[torch.Generator], cfg: ClipTextConfig, dtype=torch.float32, device="cpu"
) -> dict:
    """Random init with the JAX package's distributions (normal * 0.02)."""
    f = ParamFactory(generator, dtype, device)
    d, m = cfg.hidden_size, cfg.intermediate_size
    layers = {}
    for i in range(cfg.num_layers):
        layers[str(i)] = {
            "layer_norm1": f.norm(d),
            "layer_norm2": f.norm(d),
            "self_attn": {
                name: f.dense(d, d, std=0.02) for name in ("q_proj", "k_proj", "v_proj", "out_proj")
            },
            "mlp": {"fc1": f.dense(d, m, std=0.02), "fc2": f.dense(m, d, std=0.02)},
        }
    params = {
        "text_model": {
            "embeddings": {
                "token_embedding": {"weight": f.normal((cfg.vocab_size, d), 0.02)},
                "position_embedding": {"weight": f.normal((cfg.max_positions, d), 0.02)},
            },
            "encoder": {"layers": layers},
            "final_layer_norm": f.norm(d),
        }
    }
    if cfg.projection_dim is not None:
        params["text_projection"] = f.dense(d, cfg.projection_dim, bias=False, std=0.02)
    return params
