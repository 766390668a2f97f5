"""UNet2DConditionModel (SD1.x, SD2.x and SDXL) as a function over a
parameter dict (port of sliders_tpu/models/unet2d.py).

The parameter dict mirrors the diffusers state-dict paths, so snapshots load
mechanically (models/convert.py) and LoRA names follow the reference
convention. Latents are NHWC at `apply`; convs run channels_last.

The 3x3 convs route through the conv kernels #5-#7 under
`ops.basic.set_conv_impl` ('auto', 'fused_ep', 'fused'; default 'xla',
cuDNN everywhere), as the JAX package's UNet routes them.

`apply(..., remat=True)` recomputes each basic transformer block in the
backward pass instead of keeping its activations (non-reentrant
`torch.utils.checkpoint`, as the JAX package wraps the block in
`jax.checkpoint`, models/unet2d.py:313-318); it takes effect only when
grad mode is on.

SDXL's `text_time` micro-conditioning adds an embedding of the pooled text
embeds and the six size/crop ids to the time embedding (`apply(...,
added_cond=...)`). The token tensors at every transformer boundary go
through `ops.basic.layout_pin` (kernel #9 when `set_layout_pin(True)`, else
the identity), in the JAX package's four places and outside the remat
checkpoints, so recomputation adds no pin.

Tensor parallelism (`parallel/`): on the parameters `parallel.mesh.
shard_params` slices and inside `parallel.collectives.tensor_parallel`,
the attention and GEGLU blocks run Megatron's column / row split, one
all-reduce each forward; everything else runs replicated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from sliders_tpu_torch.models.params import ParamFactory
from sliders_tpu_torch.ops import conv3x3
from sliders_tpu_torch.ops.attention import multihead_attention
from sliders_tpu_torch.ops.basic import (
    SliderLora,
    conv2d,
    conv_impl,
    gelu,
    group_norm,
    group_norm_affine,
    layer_norm,
    layout_pin,
    linear,
    silu,
    timestep_embedding,
)
from sliders_tpu_torch.parallel.collectives import (
    active_mesh,
    copy_to_tp,
    tensor_parallel,
    tp_shard,
)


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple = (320, 640, 1280, 1280)
    down_block_types: tuple = (
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: tuple = (
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    # heads per down block (reversed for up blocks); mid uses the last entry
    num_attention_heads: tuple = (8, 8, 8, 8)
    transformer_layers_per_block: tuple = (1, 1, 1, 1)
    use_linear_projection: bool = False
    norm_num_groups: int = 32
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: Optional[int] = None

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


SD15 = UNetConfig()
SD21 = UNetConfig(
    cross_attention_dim=1024,
    num_attention_heads=(5, 10, 20, 20),
    use_linear_projection=True,
)
SDXL = UNetConfig(
    block_out_channels=(320, 640, 1280),
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
    cross_attention_dim=2048,
    num_attention_heads=(5, 10, 20),
    transformer_layers_per_block=(1, 2, 10),
    use_linear_projection=True,
    addition_embed_type="text_time",
    projection_class_embeddings_input_dim=2816,  # pooled 1280 + 6 ids x 256
)

# tiny config for CPU tests (structure-identical to SD1)
TINY = UNetConfig(
    block_out_channels=(32, 64),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=1,
    cross_attention_dim=32,
    num_attention_heads=(2, 2),
    transformer_layers_per_block=(1, 1),
    norm_num_groups=8,
)

# tiny SDXL-shaped config (text_time conditioning, linear projections)
TINY_XL = UNetConfig(
    block_out_channels=(32, 64),
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
    layers_per_block=1,
    cross_attention_dim=32,
    num_attention_heads=(2, 2),
    transformer_layers_per_block=(1, 2),
    use_linear_projection=True,
    norm_num_groups=8,
    addition_embed_type="text_time",
    addition_time_embed_dim=8,
    projection_class_embeddings_input_dim=16 + 6 * 8,  # pooled 16 + 6 ids x 8
)


def get_config(name: str) -> UNetConfig:
    return {"sd15": SD15, "sd21": SD21, "sdxl": SDXL, "tiny": TINY, "tiny_xl": TINY_XL}[name]


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _resnet(p: dict, x, emb, cfg: UNetConfig, lora, name: str):
    """diffusers ResnetBlock2D: GN-SiLU-conv x2 with the time-embedding add
    and a 1x1 shortcut when channels change. Under conv impl 'fused' an
    eligible block takes kernel #6 twice (`_resnet_fused`); under 'fused_ep'
    each conv without LoRA that passes `epi_supports` takes kernel #7 with
    its temb / residual epilogue (as `unet2d.py:139-196` of the JAX package
    routes)."""
    if _fused_resnet_eligible(p, x, lora, name):
        return _resnet_fused(p, x, emb, cfg, lora, name)
    ep = _epi_routes(lora, name)
    h = group_norm(p["norm1"], x, cfg.norm_num_groups, silu=True)
    temb = linear(p["time_emb_proj"], silu(emb), lora=lora, name=f"{name}.time_emb_proj")
    if ep and conv3x3.epi_supports(h.shape, p["conv1"]["weight"].shape):
        h = _epi_call(p["conv1"], h, temb.to(h.dtype), "temb")
    else:
        h = conv2d(p["conv1"], h, padding=1, lora=lora, name=f"{name}.conv1")
        h = h + temb[:, None, None, :]
    h2 = group_norm(p["norm2"], h, cfg.norm_num_groups, silu=True)
    res = x
    if "conv_shortcut" in p:
        res = conv2d(p["conv_shortcut"], x, padding=0, lora=lora, name=f"{name}.conv_shortcut")
    if ep and conv3x3.epi_supports(h2.shape, p["conv2"]["weight"].shape):
        return _epi_call(p["conv2"], h2, res.to(h2.dtype), "residual")
    h2 = conv2d(p["conv2"], h2, padding=1, lora=lora, name=f"{name}.conv2")
    return res + h2


def _lora_on_convs(lora, name: str) -> bool:
    return lora is not None and any(f"{name}.{m}" in lora.weights for m in ("conv1", "conv2"))


def _epi_routes(lora, name: str) -> bool:
    """Whether this block's convs may take kernel #7: conv impl 'fused_ep'
    and no LoRA on either conv."""
    return conv_impl().startswith("fused_ep") and not _lora_on_convs(lora, name)


def _epi_call(conv_p: dict, h, extra, mode: str):
    return conv3x3.epi_conv3x3(h, conv_p["weight"].to(h.dtype), conv_p["bias"].to(h.dtype),
                               extra, mode)


def _fused_resnet_eligible(p: dict, x, lora, name: str) -> bool:
    """Route this block through kernel #6? Conv impl 'fused', no LoRA on the
    block's convs (lierla networks never target them; c3lier image sliders
    fall back) and both convs pass `fused_supports`."""
    if conv_impl() not in ("fused", "fused_interpret") or _lora_on_convs(lora, name):
        return False
    w1, w2 = p["conv1"]["weight"], p["conv2"]["weight"]
    h1_shape = tuple(x.shape[:3]) + (w1.shape[0],)
    return conv3x3.fused_supports(x.shape, w1.shape) and conv3x3.fused_supports(h1_shape, w2.shape)


def _resnet_fused(p: dict, x, emb, cfg: UNetConfig, lora, name: str):
    """ResnetBlock2D through kernel #6: two GN statistics passes
    (`group_norm_affine`) and two kernel calls that apply normalise + SiLU,
    the 3x3 conv and the bias + temb / bias + residual epilogue. The
    shortcut stays a plain 1x1 conv."""
    g = cfg.norm_num_groups
    a1, s1 = group_norm_affine(p["norm1"], x, g)
    temb = linear(p["time_emb_proj"], silu(emb), lora=lora, name=f"{name}.time_emb_proj")
    dt = x.dtype
    h1 = conv3x3.fused_conv3x3(x, a1, s1, p["conv1"]["weight"].to(dt), p["conv1"]["bias"].to(dt),
                               temb.to(dt), "temb")
    a2, s2 = group_norm_affine(p["norm2"], h1, g)
    res = x
    if "conv_shortcut" in p:
        res = conv2d(p["conv_shortcut"], x, padding=0, lora=lora, name=f"{name}.conv_shortcut")
    return conv3x3.fused_conv3x3(h1, a2, s2, p["conv2"]["weight"].to(dt),
                                 p["conv2"]["bias"].to(dt), res.to(dt), "residual")


def _attention(p: dict, x, context, heads: int, lora, name: str):
    """diffusers Attention (to_q/to_k/to_v/to_out.0). Under a tp split
    (`collectives.tensor_parallel`) q/k/v run column-parallel, the
    attention on this rank's heads // tp heads, to_out.0 row-parallel."""
    col = tp_shard(f"{name}.to_q", "col")
    row = None
    if col is not None:
        if heads % col.size:
            raise ValueError(f"{name}: {heads} heads do not split over tp={col.size}")
        x = copy_to_tp(x, col.mesh)
        context = None if context is None else copy_to_tp(context, col.mesh)
        heads //= col.size
        row = tp_shard(f"{name}.to_out.0", "row")
    ctx = x if context is None else context
    q = linear(p["to_q"], x, lora=lora, name=f"{name}.to_q", tp=col)
    k = linear(p["to_k"], ctx, lora=lora, name=f"{name}.to_k", tp=col)
    v = linear(p["to_v"], ctx, lora=lora, name=f"{name}.to_v", tp=col)
    out = multihead_attention(q, k, v, heads, name=name)
    return linear(p["to_out"]["0"], out, lora=lora, name=f"{name}.to_out.0", tp=row)


def _geglu_ff(p: dict, x, lora, name: str):
    """GEGLU feed-forward; under a tp split net.0.proj runs column-parallel
    (each rank's slice of h and of gate), net.2 row-parallel."""
    col = tp_shard(f"{name}.net.0.proj", "col")
    row = None
    if col is not None:
        x = copy_to_tp(x, col.mesh)
        row = tp_shard(f"{name}.net.2", "row")
    h = linear(p["net"]["0"]["proj"], x, lora=lora, name=f"{name}.net.0.proj", tp=col)
    h, gate = h.chunk(2, dim=-1)
    h = h * gelu(gate)
    return linear(p["net"]["2"], h, lora=lora, name=f"{name}.net.2", tp=row)


def _basic_transformer_block(p: dict, x, context, heads: int, lora, name: str):
    x = x + _attention(p["attn1"], layer_norm(p["norm1"], x), None, heads, lora, f"{name}.attn1")
    x = x + _attention(p["attn2"], layer_norm(p["norm2"], x), context, heads, lora, f"{name}.attn2")
    x = x + _geglu_ff(p["ff"], layer_norm(p["norm3"], x), lora, f"{name}.ff")
    return x


def _block_under(mesh, *args):
    with tensor_parallel(mesh):
        return _basic_transformer_block(*args)


def _transformer2d(p: dict, x, context, heads: int, cfg: UNetConfig, lora, name: str,
                   remat: bool = False):
    """diffusers Transformer2DModel: GN -> proj_in -> N blocks -> proj_out
    (+ residual). proj is a 1x1 conv for SD1, a linear for SD2 and SDXL. The
    (B, L, C) token tensors are pinned on both sides (`layout_pin`)."""
    B, H, W, C = x.shape
    residual = x
    h = group_norm(p["norm"], x, cfg.norm_num_groups, eps=1e-6)
    if cfg.use_linear_projection:
        h = layout_pin(h.reshape(B, H * W, C))
        h = linear(p["proj_in"], h, lora=lora, name=f"{name}.proj_in")
    else:
        h = conv2d(p["proj_in"], h, padding=0, lora=lora, name=f"{name}.proj_in")
        h = layout_pin(h.reshape(B, H * W, C))
    blocks = p["transformer_blocks"]
    for k in range(len(blocks)):
        args = (blocks[str(k)], h, context, heads, lora, f"{name}.transformer_blocks.{k}")
        if remat and torch.is_grad_enabled():
            # the recomputation in the backward re-enters this tp split
            h = checkpoint(_block_under, active_mesh(), *args, use_reentrant=False)
        else:
            h = _basic_transformer_block(*args)
    if cfg.use_linear_projection:
        h = linear(p["proj_out"], h, lora=lora, name=f"{name}.proj_out")
        h = layout_pin(h).reshape(B, H, W, C)
    else:
        h = conv2d(p["proj_out"], layout_pin(h).reshape(B, H, W, C), padding=0, lora=lora,
                   name=f"{name}.proj_out")
    return h + residual


def _downsample(p: dict, x, lora, name: str):
    return conv2d(p["conv"], x, stride=2, padding=1, lora=lora, name=f"{name}.conv")


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """NHWC nearest-neighbour 2x upsampling (jax.image.resize 'nearest')."""
    return F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest").permute(0, 2, 3, 1)


def _upsample(p: dict, x, lora, name: str):
    return conv2d(p["conv"], upsample_nearest2x(x), padding=1, lora=lora, name=f"{name}.conv")


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def apply(
    params: dict,
    cfg: UNetConfig,
    sample: torch.Tensor,  # (B, H, W, C_in) NHWC latents
    timesteps,  # (B,) or scalar
    encoder_hidden_states: torch.Tensor,  # (B, L, cross_attention_dim)
    added_cond: Optional[dict] = None,  # SDXL: {'text_embeds': (B, 1280), 'time_ids': (B, 6)}
    lora: Optional[SliderLora] = None,
    remat: bool = False,
) -> torch.Tensor:
    """Predict the noise residual. Returns (B, H, W, C_out) in sample.dtype.
    `added_cond` is required by a `text_time` config and ignored otherwise.
    `remat` checkpoints every basic transformer block (see the module
    docstring)."""
    B = sample.shape[0]
    dtype = sample.dtype
    timesteps = torch.as_tensor(timesteps, device=sample.device).reshape(-1).expand(B)

    t_emb = timestep_embedding(timesteps, cfg.block_out_channels[0])
    emb = linear(params["time_embedding"]["linear_1"], t_emb.to(dtype))
    emb = linear(params["time_embedding"]["linear_2"], silu(emb))

    if cfg.addition_embed_type == "text_time":
        if added_cond is None:
            raise ValueError("an SDXL UNet needs added_cond {'text_embeds', 'time_ids'}")
        # each of the B x 6 ids embedded on its own, then (B, 6 * dim) in id order
        time_ids = added_cond["time_ids"].to(sample.device).reshape(-1)
        t_ids_emb = timestep_embedding(time_ids, cfg.addition_time_embed_dim).reshape(B, -1)
        add_emb = torch.cat([added_cond["text_embeds"].to(device=sample.device, dtype=dtype),
                             t_ids_emb.to(dtype)], dim=-1)
        if add_emb.shape[-1] != cfg.projection_class_embeddings_input_dim:
            raise ValueError(f"added conditioning is {add_emb.shape[-1]} wide, the config "
                             f"takes {cfg.projection_class_embeddings_input_dim}")
        aug = linear(params["add_embedding"]["linear_1"], add_emb)
        emb = emb + linear(params["add_embedding"]["linear_2"], silu(aug))
    elif cfg.addition_embed_type is not None:
        raise NotImplementedError(f"addition_embed_type {cfg.addition_embed_type!r}: only "
                                  "'text_time' (SDXL) is ported")

    ehs = encoder_hidden_states.to(dtype)
    h = conv2d(params["conv_in"], sample, padding=1, lora=lora, name="conv_in")

    res_stack = [h]
    n_blocks = len(cfg.down_block_types)
    for i, block_type in enumerate(cfg.down_block_types):
        bp = params["down_blocks"][str(i)]
        bname = f"down_blocks.{i}"
        has_attn = block_type == "CrossAttnDownBlock2D"
        for j in range(cfg.layers_per_block):
            h = _resnet(bp["resnets"][str(j)], h, emb, cfg, lora, f"{bname}.resnets.{j}")
            if has_attn:
                h = _transformer2d(
                    bp["attentions"][str(j)], h, ehs, cfg.num_attention_heads[i],
                    cfg, lora, f"{bname}.attentions.{j}", remat,
                )
            res_stack.append(h)
        if i < n_blocks - 1:
            h = _downsample(bp["downsamplers"]["0"], h, lora, f"{bname}.downsamplers.0")
            res_stack.append(h)

    mp = params["mid_block"]
    h = _resnet(mp["resnets"]["0"], h, emb, cfg, lora, "mid_block.resnets.0")
    h = _transformer2d(
        mp["attentions"]["0"], h, ehs, cfg.num_attention_heads[-1],
        cfg, lora, "mid_block.attentions.0", remat,
    )
    h = _resnet(mp["resnets"]["1"], h, emb, cfg, lora, "mid_block.resnets.1")

    rev_heads = tuple(reversed(cfg.num_attention_heads))
    for i, block_type in enumerate(cfg.up_block_types):
        bp = params["up_blocks"][str(i)]
        bname = f"up_blocks.{i}"
        has_attn = block_type == "CrossAttnUpBlock2D"
        for j in range(cfg.layers_per_block + 1):
            h = torch.cat([h, res_stack.pop()], dim=-1)
            h = _resnet(bp["resnets"][str(j)], h, emb, cfg, lora, f"{bname}.resnets.{j}")
            if has_attn:
                h = _transformer2d(
                    bp["attentions"][str(j)], h, ehs, rev_heads[i],
                    cfg, lora, f"{bname}.attentions.{j}", remat,
                )
        if i < n_blocks - 1:
            h = _upsample(bp["upsamplers"]["0"], h, lora, f"{bname}.upsamplers.0")

    h = group_norm(params["conv_norm_out"], h, cfg.norm_num_groups, silu=True)
    return conv2d(params["conv_out"], h, padding=1, lora=lora, name="conv_out")


# ---------------------------------------------------------------------------
# init (tests / benchmarks; real weights via models/loader.py)
# ---------------------------------------------------------------------------


def attention_heads(cfg: UNetConfig) -> dict:
    """{attention path: head count} of every attn1 / attn2 of the UNet (the
    head counts `parallel.mesh.shard_params` checks against tp)."""
    out = {}

    def add(prefix, heads, layers):
        for k in range(layers):
            for a in ("attn1", "attn2"):
                out[f"{prefix}.transformer_blocks.{k}.{a}"] = heads

    for i, bt in enumerate(cfg.down_block_types):
        if bt == "CrossAttnDownBlock2D":
            for j in range(cfg.layers_per_block):
                add(f"down_blocks.{i}.attentions.{j}", cfg.num_attention_heads[i],
                    cfg.transformer_layers_per_block[i])
    add("mid_block.attentions.0", cfg.num_attention_heads[-1], cfg.transformer_layers_per_block[-1])
    rev_heads = tuple(reversed(cfg.num_attention_heads))
    rev_layers = tuple(reversed(cfg.transformer_layers_per_block))
    for i, bt in enumerate(cfg.up_block_types):
        if bt == "CrossAttnUpBlock2D":
            for j in range(cfg.layers_per_block + 1):
                add(f"up_blocks.{i}.attentions.{j}", rev_heads[i], rev_layers[i])
    return out


def geglu_units(cfg: UNetConfig) -> set:
    """The feed-forward of every transformer block of the UNet: GEGLU,
    whose `net.0.proj` outputs [h | gate] (the units whose halves
    `parallel.mesh.shard_params` splits apart)."""
    return {a.rsplit(".", 1)[0] + ".ff" for a in attention_heads(cfg)}


def _down_channel_plan(cfg: UNetConfig):
    plan = []
    out_ch = cfg.block_out_channels[0]
    for i in range(len(cfg.down_block_types)):
        in_ch, out_ch = out_ch, cfg.block_out_channels[i]
        plan.append([(in_ch if j == 0 else out_ch, out_ch) for j in range(cfg.layers_per_block)])
    return plan


def _up_channel_plan(cfg: UNetConfig):
    rev = tuple(reversed(cfg.block_out_channels))
    plan = []
    out_ch = rev[0]
    for i in range(len(cfg.up_block_types)):
        prev_out, out_ch = out_ch, rev[i]
        in_ch = rev[min(i + 1, len(rev) - 1)]
        n = cfg.layers_per_block + 1
        layers = []
        for j in range(n):
            skip_ch = in_ch if j == n - 1 else out_ch
            res_in = prev_out if j == 0 else out_ch
            layers.append((res_in + skip_ch, out_ch))
        plan.append(layers)
    return plan


def init_params(
    generator: Optional[torch.Generator], cfg: UNetConfig, dtype=torch.float32, device="cpu"
) -> dict:
    f = ParamFactory(generator, dtype, device)
    ted = cfg.time_embed_dim

    def resnet(i, o):
        p = {
            "norm1": f.norm(i),
            "conv1": f.conv(i, o),
            "time_emb_proj": f.dense(ted, o),
            "norm2": f.norm(o),
            "conv2": f.conv(o, o),
        }
        if i != o:
            p["conv_shortcut"] = f.conv(i, o, k=1)
        return p

    def attn(c, ctx_dim):
        return {
            "to_q": f.dense(c, c, bias=False),
            "to_k": f.dense(ctx_dim, c, bias=False),
            "to_v": f.dense(ctx_dim, c, bias=False),
            "to_out": {"0": f.dense(c, c)},
        }

    def tblock(c):
        return {
            "norm1": f.norm(c),
            "attn1": attn(c, c),
            "norm2": f.norm(c),
            "attn2": attn(c, cfg.cross_attention_dim),
            "norm3": f.norm(c),
            "ff": {"net": {"0": {"proj": f.dense(c, c * 8)}, "2": f.dense(c * 4, c)}},
        }

    def transformer(c, n_layers):
        proj_in = f.dense(c, c) if cfg.use_linear_projection else f.conv(c, c, k=1)
        proj_out = f.dense(c, c) if cfg.use_linear_projection else f.conv(c, c, k=1)
        return {
            "norm": f.norm(c),
            "proj_in": proj_in,
            "transformer_blocks": {str(k): tblock(c) for k in range(n_layers)},
            "proj_out": proj_out,
        }

    params: dict = {
        "conv_in": f.conv(cfg.in_channels, cfg.block_out_channels[0]),
        "time_embedding": {
            "linear_1": f.dense(cfg.block_out_channels[0], ted),
            "linear_2": f.dense(ted, ted),
        },
        "conv_norm_out": f.norm(cfg.block_out_channels[0]),
        "conv_out": f.conv(cfg.block_out_channels[0], cfg.out_channels),
    }
    if cfg.addition_embed_type == "text_time":
        params["add_embedding"] = {
            "linear_1": f.dense(cfg.projection_class_embeddings_input_dim, ted),
            "linear_2": f.dense(ted, ted),
        }

    down = {}
    n_blocks = len(cfg.down_block_types)
    for i, (block_type, layers) in enumerate(zip(cfg.down_block_types, _down_channel_plan(cfg))):
        bp: dict = {"resnets": {}}
        if block_type == "CrossAttnDownBlock2D":
            bp["attentions"] = {}
        for j, (ic, oc) in enumerate(layers):
            bp["resnets"][str(j)] = resnet(ic, oc)
            if block_type == "CrossAttnDownBlock2D":
                bp["attentions"][str(j)] = transformer(oc, cfg.transformer_layers_per_block[i])
        if i < n_blocks - 1:
            oc = cfg.block_out_channels[i]
            bp["downsamplers"] = {"0": {"conv": f.conv(oc, oc)}}
        down[str(i)] = bp
    params["down_blocks"] = down

    mid_c = cfg.block_out_channels[-1]
    params["mid_block"] = {
        "resnets": {"0": resnet(mid_c, mid_c), "1": resnet(mid_c, mid_c)},
        "attentions": {"0": transformer(mid_c, cfg.transformer_layers_per_block[-1])},
    }

    up = {}
    rev_tlayers = tuple(reversed(cfg.transformer_layers_per_block))
    for i, (block_type, layers) in enumerate(zip(cfg.up_block_types, _up_channel_plan(cfg))):
        bp = {"resnets": {}}
        if block_type == "CrossAttnUpBlock2D":
            bp["attentions"] = {}
        for j, (ic, oc) in enumerate(layers):
            bp["resnets"][str(j)] = resnet(ic, oc)
            if block_type == "CrossAttnUpBlock2D":
                bp["attentions"][str(j)] = transformer(oc, rev_tlayers[i])
        if i < n_blocks - 1:
            oc = tuple(reversed(cfg.block_out_channels))[i]
            bp["upsamplers"] = {"0": {"conv": f.conv(oc, oc)}}
        up[str(i)] = bp
    params["up_blocks"] = up
    return params
