"""FLUX-1 MMDiT transformer (FluxTransformer2DModel) as a function over a
parameter dict (port of sliders_tpu/models/flux.py).

The backbone of the reference's FLUX sliders (flux-sliders/utils/
custom_flux_pipeline.py drives it per step at timestep/1000 with a guidance
embedding, packed 2x2 latents and RoPE ids; :420-455, :687-731). The
parameter dict mirrors the diffusers state dict (x_embedder /
time_text_embed / transformer_blocks.N / single_transformer_blocks.N /
norm_out / proj_out) in torch layouts, and LoRA call-site names are the
module paths (`transformer_blocks.N.attn.to_q`, ...).

Numerics as in the JAX package: activations in the weights' compute dtype,
LayerNorm (eps 1e-6, no affine) and the per-head q/k RMSNorm in f32, RoPE
applied in f32, GELU with the tanh approximation. The joint attention
(context first) routes as every attention does (`ops/attention.py`): kernel
#1 up to 1536 px in bf16, kernel #4 beyond.

`apply(..., remat=True)` recomputes each double- and single-stream block in
the backward instead of keeping its activations (`torch.utils.checkpoint`,
non-reentrant, as the JAX package wraps the blocks in `jax.checkpoint`,
models/flux.py:296-298); it takes effect only when grad mode is on.

Under a tp split (`parallel.collectives.tensor_parallel`, the tree from
`parallel.mesh.shard_params`) each block runs Megatron-style on this rank's
heads // tp heads: `copy_to_tp` in front of the column-split projections
(q/k/v of both streams, the MLPs' `net.0.proj`, a single block's
`proj_mlp`) and one `reduce_from_tp` per row-split output, four a double
block (`to_out.0`, `to_add_out`, `ff.net.2`, `ff_context.net.2`) and one a
single block (`proj_out`, whose input is [this rank's attention features |
its MLP features]). The per-head q/k RMSNorm, RoPE and the joint attention
stay local; the adaLN modulations, the embedders and the final layer run
replicated. A checkpointed block re-enters the split in its recomputation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from sliders_tpu_torch.models.params import ParamFactory
from sliders_tpu_torch.ops.attention import multihead_attention
from sliders_tpu_torch.ops.basic import SliderLora, gelu_tanh, linear, silu, timestep_embedding
from sliders_tpu_torch.parallel.collectives import (
    active_mesh,
    copy_to_tp,
    tensor_parallel,
    tp_shard,
)


@dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64  # packed 2x2 x 16 latent channels
    num_layers: int = 19  # double-stream blocks
    num_single_layers: int = 38
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096  # T5 features
    pooled_projection_dim: int = 768  # CLIP-L pooled
    guidance_embeds: bool = True  # dev; False for schnell
    axes_dims_rope: tuple = (16, 56, 56)
    rope_theta: float = 10000.0

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


FLUX_DEV = FluxConfig()
FLUX_SCHNELL = FluxConfig(guidance_embeds=False)
TINY = FluxConfig(
    in_channels=16,  # packed 2x2 x 4 latent channels
    num_layers=2,
    num_single_layers=2,
    attention_head_dim=16,
    num_attention_heads=2,
    joint_attention_dim=32,
    pooled_projection_dim=24,
    axes_dims_rope=(4, 6, 6),
)


# -- latent packing and position ids (custom_flux_pipeline.py:420-455) -------


def pack_latents(latents: torch.Tensor) -> torch.Tensor:
    """NHWC latents (B, H, W, C) -> (B, H/2*W/2, 4C) 2x2 patches, CHANNEL-MAJOR
    (each token is the (C, 2, 2) patch flattened as c*4 + i*2 + j, diffusers
    FluxPipeline `_pack_latents`): the order a real checkpoint's x_embedder
    rows are trained against."""
    B, H, W, C = latents.shape
    x = latents.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(B, (H // 2) * (W // 2), 4 * C)


def unpack_latents(packed: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, H/2*W/2, 4C) -> NHWC (B, H, W, C); the inverse of `pack_latents`."""
    B, _, C4 = packed.shape
    C = C4 // 4
    x = packed.reshape(B, height // 2, width // 2, C, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, height, width, C)


def image_ids(height: int, width: int) -> np.ndarray:
    """(H/2*W/2, 3) RoPE ids: column 0 zero, 1 the row, 2 the column."""
    h, w = height // 2, width // 2
    ids = np.zeros((h, w, 3), np.float32)
    ids[..., 1] = np.arange(h)[:, None]
    ids[..., 2] = np.arange(w)[None, :]
    return ids.reshape(h * w, 3)


def text_ids(seq_len: int) -> np.ndarray:
    return np.zeros((seq_len, 3), np.float32)


def rope_tables(ids: torch.Tensor, cfg: FluxConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """ids (L, 3) -> (cos, sin), each (L, head_dim) f32, interleaved pairs."""
    cos, sin = [], []
    for axis, dim in enumerate(cfg.axes_dims_rope):
        freqs = 1.0 / (cfg.rope_theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                                        device=ids.device) / dim))
        angles = ids[:, axis:axis + 1].float() * freqs[None]  # (L, dim/2)
        cos.append(torch.repeat_interleave(torch.cos(angles), 2, dim=-1))
        sin.append(torch.repeat_interleave(torch.sin(angles), 2, dim=-1))
    return torch.cat(cos, -1), torch.cat(sin, -1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               num_heads: int) -> torch.Tensor:
    """x (B, L, H*d): rotate each head's interleaved pairs, in f32."""
    B, L, D = x.shape
    xh = x.reshape(B, L, num_heads, D // num_heads).float()
    rotated = torch.stack([-xh[..., 1::2], xh[..., 0::2]], dim=-1).reshape(xh.shape)
    out = xh * cos[None, :, None, :] + rotated * sin[None, :, None, :]
    return out.reshape(B, L, D).to(x.dtype)


# -- blocks -------------------------------------------------------------------


def _rms_qk(p: dict, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Per-head RMSNorm on q/k (weight over the head dim, eps 1e-6), in f32."""
    B, L, D = x.shape
    xh = x.reshape(B, L, num_heads, D // num_heads).float()
    xh = xh * torch.rsqrt(xh.square().mean(-1, keepdim=True) + 1e-6)
    return (xh * p["weight"].float()).reshape(B, L, D).to(x.dtype)


def _ln(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm without affine parameters, eps 1e-6, f32 statistics."""
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=-1, keepdim=True, correction=0)
    return ((xf - mean) * torch.rsqrt(var + 1e-6)).to(x.dtype)


def _modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return _ln(x) * (1 + scale[:, None]) + shift[:, None]


def _mlp(p: dict, x: torch.Tensor, lora, name: str) -> torch.Tensor:
    """The tanh-GELU MLP; under a tp split net.0.proj runs column-parallel
    (a contiguous slice of the hidden features), net.2 row-parallel."""
    col = tp_shard(f"{name}.net.0.proj", "col")
    row = None
    if col is not None:
        x = copy_to_tp(x, col.mesh)
        row = tp_shard(f"{name}.net.2", "row")
    h = gelu_tanh(linear(p["net"]["0"]["proj"], x, lora=lora, name=f"{name}.net.0.proj", tp=col))
    return linear(p["net"]["2"], h, lora=lora, name=f"{name}.net.2", tp=row)


def _local_heads(heads: int, col, name: str) -> int:
    if col is None:
        return heads
    if heads % col.size:
        raise ValueError(f"{name}: {heads} heads do not split over tp={col.size}")
    return heads // col.size


def _double_block(p: dict, img, txt, temb, cos, sin, cfg: FluxConfig, lora, name: str):
    # adaLN-zero modulation, six chunks for each stream
    sh_a, sc_a, g_a, sh_m, sc_m, g_m = linear(p["norm1"]["linear"], silu(temb)).chunk(6, dim=-1)
    csh_a, csc_a, cg_a, csh_m, csc_m, cg_m = linear(
        p["norm1_context"]["linear"], silu(temb)).chunk(6, dim=-1)
    img_n = _modulate(img, sh_a, sc_a)
    txt_n = _modulate(txt, csh_a, csc_a)

    a, an = p["attn"], f"{name}.attn"
    col = tp_shard(f"{an}.to_q", "col")
    heads = _local_heads(cfg.num_attention_heads, col, an)
    if col is not None:
        img_n, txt_n = copy_to_tp(img_n, col.mesh), copy_to_tp(txt_n, col.mesh)

    def proj(key, x):
        mode = "row" if key in ("to_out.0", "to_add_out") else "col"
        w = a["to_out"]["0"] if key == "to_out.0" else a[key]
        return linear(w, x, lora=lora, name=f"{an}.{key}", tp=tp_shard(f"{an}.{key}", mode))

    q = _rms_qk(a["norm_q"], proj("to_q", img_n), heads)
    k = _rms_qk(a["norm_k"], proj("to_k", img_n), heads)
    cq = _rms_qk(a["norm_added_q"], proj("add_q_proj", txt_n), heads)
    ck = _rms_qk(a["norm_added_k"], proj("add_k_proj", txt_n), heads)
    # the joint sequence puts the context first (diffusers FluxAttnProcessor)
    q = apply_rope(torch.cat([cq, q], dim=1), cos, sin, heads)
    k = apply_rope(torch.cat([ck, k], dim=1), cos, sin, heads)
    vv = torch.cat([proj("add_v_proj", txt_n), proj("to_v", img_n)], dim=1)
    out = multihead_attention(q, k, vv, heads)
    n_txt = txt.shape[1]
    img_out = proj("to_out.0", out[:, n_txt:])
    ctx_out = proj("to_add_out", out[:, :n_txt])

    img = img + g_a[:, None] * img_out
    img = img + g_m[:, None] * _mlp(p["ff"], _modulate(img, sh_m, sc_m), lora, f"{name}.ff")
    txt = txt + cg_a[:, None] * ctx_out
    txt = txt + cg_m[:, None] * _mlp(p["ff_context"], _modulate(txt, csh_m, csc_m), lora,
                                     f"{name}.ff_context")
    return img, txt


def _single_block(p: dict, x, temb, cos, sin, cfg: FluxConfig, lora, name: str):
    shift, scale, gate = linear(p["norm"]["linear"], silu(temb)).chunk(3, dim=-1)
    xn = _modulate(x, shift, scale)
    a, an = p["attn"], f"{name}.attn"
    col = tp_shard(f"{an}.to_q", "col")
    heads = _local_heads(cfg.num_attention_heads, col, name)
    if col is not None:
        xn = copy_to_tp(xn, col.mesh)

    def proj(w, key, mode="col"):
        return linear(w, xn, lora=lora, name=key, tp=tp_shard(key, mode))

    q = _rms_qk(a["norm_q"], proj(a["to_q"], f"{an}.to_q"), heads)
    k = _rms_qk(a["norm_k"], proj(a["to_k"], f"{an}.to_k"), heads)
    v = proj(a["to_v"], f"{an}.to_v")
    attn_out = multihead_attention(apply_rope(q, cos, sin, heads), apply_rope(k, cos, sin, heads),
                                   v, heads)
    mlp = gelu_tanh(proj(p["proj_mlp"], f"{name}.proj_mlp"))
    out = linear(p["proj_out"], torch.cat([attn_out, mlp], dim=-1), lora=lora,
                 name=f"{name}.proj_out", tp=tp_shard(f"{name}.proj_out", "row"))
    return x + gate[:, None] * out


def _block_under(mesh, block, *args):
    with tensor_parallel(mesh):
        return block(*args)


def keep_blocks(params: dict, keep) -> dict:
    """`params` with `keep(prefix, block)` applied to each block (see
    `init_params`), for a tree already loaded."""
    out = dict(params)
    for family in ("transformer_blocks", "single_transformer_blocks"):
        kept = {}
        for i, block in params[family].items():
            block = keep(f"{family}.{i}", block)
            if block is not None:
                kept[i] = block
        out[family] = kept
    return out


# -- forward ------------------------------------------------------------------


def embed_inputs(params: dict, cfg: FluxConfig, packed_latents: torch.Tensor,
                 timestep: torch.Tensor, pooled: torch.Tensor,
                 encoder_hidden_states: torch.Tensor,
                 guidance: Optional[torch.Tensor] = None):
    """The pre-block embeddings: (img, txt, temb). `timestep` is (B,) in
    [0, 1] (the pipeline passes t/1000), `guidance` the raw (B,) scale."""
    dtype = packed_latents.dtype
    img = linear(params["x_embedder"], packed_latents)
    txt = linear(params["context_embedder"], encoder_hidden_states.to(dtype))
    tte = params["time_text_embed"]

    def embedder(p, x):
        return linear(p["linear_2"], silu(linear(p["linear_1"], x)))

    temb = embedder(tte["timestep_embedder"],
                    timestep_embedding(timestep.float() * 1000.0, 256).to(dtype))
    if cfg.guidance_embeds:
        if guidance is None:
            raise ValueError("this FLUX variant needs a guidance input")
        temb = temb + embedder(tte["guidance_embedder"],
                               timestep_embedding(guidance.float() * 1000.0, 256).to(dtype))
    temb = temb + embedder(tte["text_embedder"], pooled.to(dtype))
    return img, txt, temb


def final_layer(params: dict, img: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
    """AdaLayerNormContinuous + patch de-embedding (diffusers norm_out /
    proj_out): scale first, then shift, in the diffusers chunk order."""
    scale, shift = linear(params["norm_out"]["linear"], silu(temb)).chunk(2, dim=-1)
    return linear(params["proj_out"], _modulate(img, shift, scale))


def apply(params: dict, cfg: FluxConfig, packed_latents: torch.Tensor, timestep: torch.Tensor,
          pooled: torch.Tensor, encoder_hidden_states: torch.Tensor, txt_ids_arr, img_ids_arr,
          guidance: Optional[torch.Tensor] = None, lora: Optional[SliderLora] = None,
          remat: bool = False) -> torch.Tensor:
    """The flow velocity (B, L_img, in_channels). `txt_ids_arr` (L_txt, 3)
    and `img_ids_arr` (L_img, 3) are arrays or tensors of RoPE ids. `remat`
    checkpoints every block (see the module docstring)."""
    img, txt, temb = embed_inputs(params, cfg, packed_latents, timestep, pooled,
                                  encoder_hidden_states, guidance)
    ids = torch.cat([torch.as_tensor(txt_ids_arr), torch.as_tensor(img_ids_arr)]).to(img.device)
    cos, sin = rope_tables(ids, cfg)

    def run(block, *args):
        if remat and torch.is_grad_enabled():
            # the recomputation in the backward re-enters this tp split
            return checkpoint(_block_under, active_mesh(), block, *args, use_reentrant=False)
        return block(*args)

    for i in range(cfg.num_layers):
        img, txt = run(_double_block, params["transformer_blocks"][str(i)], img, txt, temb, cos,
                       sin, cfg, lora, f"transformer_blocks.{i}")
    x = torch.cat([txt, img], dim=1)
    for i in range(cfg.num_single_layers):
        x = run(_single_block, params["single_transformer_blocks"][str(i)], x, temb, cos, sin,
                cfg, lora, f"single_transformer_blocks.{i}")
    return final_layer(params, x[:, txt.shape[1]:], temb)


# -- init -----------------------------------------------------------------------


def init_params(generator: Optional[torch.Generator], cfg: FluxConfig, dtype=torch.float32,
                device="cpu", keep=None) -> dict:
    """Random init with the JAX package's distributions (normal weights *
    fan_in^-1/2, zero biases, unit RMSNorm scales), each leaf drawn in
    `dtype` on `device`: FLUX-dev in bf16 is 23.8 GB and never exists in
    f32. `keep(prefix, block)`, if given, is called on each block as soon
    as it is drawn (prefix `transformer_blocks.N` or
    `single_transformer_blocks.N`) and its result kept in its place, None
    dropping the block: a rank of a mesh draws the whole stream in the
    world-1 order and holds only its shard or its stage."""
    f = ParamFactory(generator, dtype, device)
    D, d_head = cfg.inner_dim, cfg.attention_head_dim

    def rms():
        return {"weight": f.const((d_head,), 1.0)}

    def mlp():
        return {"net": {"0": {"proj": f.dense(D, 4 * D)}, "2": f.dense(4 * D, D)}}

    def double():
        return {
            "norm1": {"linear": f.dense(D, 6 * D)},
            "norm1_context": {"linear": f.dense(D, 6 * D)},
            "attn": {
                **{key: f.dense(D, D) for key in ("to_q", "to_k", "to_v", "add_q_proj",
                                                  "add_k_proj", "add_v_proj")},
                "norm_q": rms(), "norm_k": rms(), "norm_added_q": rms(), "norm_added_k": rms(),
                "to_out": {"0": f.dense(D, D)},
                "to_add_out": f.dense(D, D),
            },
            "ff": mlp(),
            "ff_context": mlp(),
        }

    def single():
        return {
            "norm": {"linear": f.dense(D, 3 * D)},
            "attn": {"to_q": f.dense(D, D), "to_k": f.dense(D, D), "to_v": f.dense(D, D),
                     "norm_q": rms(), "norm_k": rms()},
            "proj_mlp": f.dense(D, 4 * D),
            "proj_out": f.dense(5 * D, D),
        }

    def embedder(i):
        return {"linear_1": f.dense(i, D), "linear_2": f.dense(D, D)}

    def kept(family, draw, n):
        blocks = {}
        for i in range(n):
            block = draw()
            if keep is not None:
                block = keep(f"{family}.{i}", block)
            if block is not None:
                blocks[str(i)] = block
        return blocks

    tte = {"timestep_embedder": embedder(256),
           "text_embedder": embedder(cfg.pooled_projection_dim)}
    if cfg.guidance_embeds:
        tte["guidance_embedder"] = embedder(256)
    return {
        "x_embedder": f.dense(cfg.in_channels, D),
        "context_embedder": f.dense(cfg.joint_attention_dim, D),
        "time_text_embed": tte,
        "transformer_blocks": kept("transformer_blocks", double, cfg.num_layers),
        "single_transformer_blocks": kept("single_transformer_blocks", single,
                                          cfg.num_single_layers),
        "norm_out": {"linear": f.dense(D, 2 * D)},
        "proj_out": f.dense(D, cfg.in_channels),
    }
