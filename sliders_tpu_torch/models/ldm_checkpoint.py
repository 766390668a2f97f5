"""Single-file SD checkpoints in the original LDM key layout (port of
sliders_tpu/models/ldm_checkpoint.py).

The reference accepts `.ckpt` / `.safetensors` single files through
diffusers' from_ckpt (model_util.load_checkpoint_model, model_util.py:77-101).
This module maps the latent-diffusion key layout (model.diffusion_model.* /
first_stage_model.* / cond_stage_model.transformer.*) onto the port's
diffusers-named parameter trees. The correspondence is a list of explicit
(ldm_key, diffusers_key) pairs generated from the architecture config, so it
is auditable and invertible (`diffusers_to_ldm_keys`).

Both layouts store torch layouts, so a weight needs no transpose: only the
VAE's attention q / k / v / proj_out, 1x1 convs in LDM files, become the
linears the port's VAE holds. The trees come out as `convert.py` gives a
diffusers snapshot, 4-D conv weights laid out channels_last (`params.tree_to`).
A `.safetensors` file is read by the port's own reader
(`convert.read_safetensors`), a `.ckpt` by `torch.load(weights_only=True)`.
"""

from __future__ import annotations

from typing import Iterator, Mapping, Optional

import torch

from sliders_tpu_torch.models import convert, unet2d
from sliders_tpu_torch.models import vae as vae_mod
from sliders_tpu_torch.models.params import tree_to
from sliders_tpu_torch.utils import pytree

# ---------------------------------------------------------------------------
# UNet key pairs
# ---------------------------------------------------------------------------

_RES_MAP = [
    ("in_layers.0", "norm1"),
    ("in_layers.2", "conv1"),
    ("emb_layers.1", "time_emb_proj"),
    ("out_layers.0", "norm2"),
    ("out_layers.3", "conv2"),
    ("skip_connection", "conv_shortcut"),
]


def _unet_key_pairs(cfg: unet2d.UNetConfig) -> Iterator[tuple[str, str]]:
    P = "model.diffusion_model"
    yield f"{P}.time_embed.0", "time_embedding.linear_1"
    yield f"{P}.time_embed.2", "time_embedding.linear_2"
    yield f"{P}.input_blocks.0.0", "conv_in"
    yield f"{P}.out.0", "conv_norm_out"
    yield f"{P}.out.2", "conv_out"
    if cfg.addition_embed_type == "text_time":
        yield f"{P}.label_emb.0.0", "add_embedding.linear_1"
        yield f"{P}.label_emb.0.2", "add_embedding.linear_2"

    n_levels = len(cfg.block_out_channels)
    lpb = cfg.layers_per_block

    def transformer_pairs(ldm_parent, d_parent, n_layers):
        yield f"{ldm_parent}.norm", f"{d_parent}.norm"
        yield f"{ldm_parent}.proj_in", f"{d_parent}.proj_in"
        yield f"{ldm_parent}.proj_out", f"{d_parent}.proj_out"
        for m in range(n_layers):
            lb = f"{ldm_parent}.transformer_blocks.{m}"
            db = f"{d_parent}.transformer_blocks.{m}"
            for sub in (
                "attn1.to_q", "attn1.to_k", "attn1.to_v", "attn1.to_out.0",
                "attn2.to_q", "attn2.to_k", "attn2.to_v", "attn2.to_out.0",
                "ff.net.0.proj", "ff.net.2", "norm1", "norm2", "norm3",
            ):
                yield f"{lb}.{sub}", f"{db}.{sub}"

    # down path
    idx = 1
    for i, btype in enumerate(cfg.down_block_types):
        has_attn = btype == "CrossAttnDownBlock2D"
        for j in range(lpb):
            for lk, dk in _RES_MAP:
                yield f"{P}.input_blocks.{idx}.0.{lk}", f"down_blocks.{i}.resnets.{j}.{dk}"
            if has_attn:
                yield from transformer_pairs(
                    f"{P}.input_blocks.{idx}.1",
                    f"down_blocks.{i}.attentions.{j}",
                    cfg.transformer_layers_per_block[i],
                )
            idx += 1
        if i < n_levels - 1:
            yield f"{P}.input_blocks.{idx}.0.op", f"down_blocks.{i}.downsamplers.0.conv"
            idx += 1

    # mid
    for lk, dk in _RES_MAP:
        yield f"{P}.middle_block.0.{lk}", f"mid_block.resnets.0.{dk}"
        yield f"{P}.middle_block.2.{lk}", f"mid_block.resnets.1.{dk}"
    yield from transformer_pairs(
        f"{P}.middle_block.1", "mid_block.attentions.0",
        cfg.transformer_layers_per_block[-1],
    )

    # up path: the upsampler sits at position 2 after an attention, else 1
    rev_tl = tuple(reversed(cfg.transformer_layers_per_block))
    idx = 0
    for i, btype in enumerate(cfg.up_block_types):
        has_attn = btype == "CrossAttnUpBlock2D"
        for j in range(lpb + 1):
            for lk, dk in _RES_MAP:
                yield f"{P}.output_blocks.{idx}.0.{lk}", f"up_blocks.{i}.resnets.{j}.{dk}"
            if has_attn:
                yield from transformer_pairs(
                    f"{P}.output_blocks.{idx}.1",
                    f"up_blocks.{i}.attentions.{j}",
                    rev_tl[i],
                )
            if j == lpb and i < n_levels - 1:
                up_pos = 2 if has_attn else 1
                yield f"{P}.output_blocks.{idx}.{up_pos}.conv", f"up_blocks.{i}.upsamplers.0.conv"
            idx += 1


# ---------------------------------------------------------------------------
# VAE key pairs
# ---------------------------------------------------------------------------

_VAE_RES = [("norm1", "norm1"), ("conv1", "conv1"), ("norm2", "norm2"),
            ("conv2", "conv2"), ("nin_shortcut", "conv_shortcut")]
_VAE_ATTN = [("norm", "group_norm"), ("q", "to_q"), ("k", "to_k"),
             ("v", "to_v"), ("proj_out", "to_out.0")]


def _vae_key_pairs(cfg: vae_mod.VaeConfig) -> Iterator[tuple[str, str]]:
    P = "first_stage_model"
    n = len(cfg.block_out_channels)
    yield f"{P}.quant_conv", "quant_conv"
    yield f"{P}.post_quant_conv", "post_quant_conv"
    for side in ("encoder", "decoder"):
        yield f"{P}.{side}.conv_in", f"{side}.conv_in"
        yield f"{P}.{side}.conv_out", f"{side}.conv_out"
        yield f"{P}.{side}.norm_out", f"{side}.conv_norm_out"
        for b, idx in (("block_1", "0"), ("block_2", "1")):
            for lk, dk in _VAE_RES:
                yield f"{P}.{side}.mid.{b}.{lk}", f"{side}.mid_block.resnets.{idx}.{dk}"
        for lk, dk in _VAE_ATTN:
            yield f"{P}.{side}.mid.attn_1.{lk}", f"{side}.mid_block.attentions.0.{dk}"
    # encoder down blocks
    for i in range(n):
        for j in range(cfg.layers_per_block):
            for lk, dk in _VAE_RES:
                yield f"{P}.encoder.down.{i}.block.{j}.{lk}", f"encoder.down_blocks.{i}.resnets.{j}.{dk}"
        if i < n - 1:
            yield f"{P}.encoder.down.{i}.downsample.conv", f"encoder.down_blocks.{i}.downsamplers.0.conv"
    # decoder up blocks: LDM decoder.up is indexed low-res LAST
    # (diffusers up_blocks[i] == ldm decoder.up[n-1-i])
    for i in range(n):
        ldm_i = n - 1 - i
        for j in range(cfg.layers_per_block + 1):
            for lk, dk in _VAE_RES:
                yield f"{P}.decoder.up.{ldm_i}.block.{j}.{lk}", f"decoder.up_blocks.{i}.resnets.{j}.{dk}"
        if i < n - 1:
            yield f"{P}.decoder.up.{ldm_i}.upsample.conv", f"decoder.up_blocks.{i}.upsamplers.0.conv"


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------

TEXT_PREFIX = "cond_stage_model.transformer."
_VAE_ATTN_LINEAR_SUFFIXES = ("to_q", "to_k", "to_v", "to_out.0")


def convert_ldm_state(
    state: Mapping[str, torch.Tensor],
    unet_cfg: unet2d.UNetConfig,
    vae_cfg: Optional[vae_mod.VaeConfig] = None,
    text_prefix: str = TEXT_PREFIX,
):
    """LDM single-file state dict -> (unet_tree, vae_tree, text_tree) on the
    state's device in its dtypes. Missing components come back as None."""

    def gather(pairs) -> dict[str, torch.Tensor]:
        out = {}
        for ldm_base, d_base in pairs:
            for suffix in (".weight", ".bias"):
                k = ldm_base + suffix
                if k in state:
                    out[d_base + suffix] = torch.as_tensor(state[k])
        return out

    def tree(flat: dict):
        return tree_to(convert.convert_state_dict(flat)) if flat else None

    unet_tree = tree(gather(_unet_key_pairs(unet_cfg)))

    vae_tree = None
    if vae_cfg is not None:
        vae_flat = gather(_vae_key_pairs(vae_cfg))
        # LDM VAE attention q/k/v/proj_out are 1x1 convs (C, C, 1, 1) where
        # diffusers uses linears (C, C)
        for k in list(vae_flat):
            if any(k.endswith(s + ".weight") for s in _VAE_ATTN_LINEAR_SUFFIXES):
                w = vae_flat[k]
                if w.ndim == 4:
                    vae_flat[k] = w[:, :, 0, 0].contiguous()
        vae_tree = tree(vae_flat)

    text_tree = tree({
        k[len(text_prefix):]: torch.as_tensor(v)
        for k, v in state.items()
        if k.startswith(text_prefix) and "position_ids" not in k
    })
    return unet_tree, vae_tree, text_tree


def load_single_file(path: str, unet_cfg: unet2d.UNetConfig, vae_cfg=None):
    """Load a .ckpt (torch pickle; its tensors, unwrapped from 'state_dict',
    in f32) or .safetensors (stored dtypes) single-file checkpoint ->
    (unet_tree, vae_tree, text_tree) on the CPU."""
    if path.endswith(".safetensors"):
        state = convert.read_safetensors(path)
    else:
        raw = torch.load(path, map_location="cpu", weights_only=True)
        raw = raw.get("state_dict", raw)
        state = {k: v.float() for k, v in raw.items() if isinstance(v, torch.Tensor)}
    return convert_ldm_state(state, unet_cfg, vae_cfg)


def diffusers_to_ldm_keys(unet_cfg: unet2d.UNetConfig, vae_cfg=None) -> dict[str, str]:
    """diffusers path base -> ldm key base (for export / tests)."""
    out = {d: l for l, d in _unet_key_pairs(unet_cfg)}
    if vae_cfg is not None:
        out.update({d: l for l, d in _vae_key_pairs(vae_cfg)})
    return out


def to_ldm_state(unet_tree: dict, unet_cfg: unet2d.UNetConfig, vae_tree: Optional[dict] = None,
                 vae_cfg: Optional[vae_mod.VaeConfig] = None, text_tree: Optional[dict] = None,
                 text_prefix: str = TEXT_PREFIX) -> dict[str, torch.Tensor]:
    """The inverse of `convert_ldm_state`: diffusers-named trees -> one flat
    LDM state dict (the VAE's attention linears as 1x1 convs), the tensors
    themselves. Raises KeyError on a parameter the key map does not name."""
    out = {}
    parts = [(unet_tree, diffusers_to_ldm_keys(unet_cfg), False)]
    if vae_tree is not None:
        parts.append((vae_tree, {d: l for l, d in _vae_key_pairs(vae_cfg)}, True))
    for tree, key_map, is_vae in parts:
        for path, w in pytree.flatten(tree).items():
            base, _, suffix = path.rpartition(".")
            if is_vae and w.ndim == 2 and base.endswith(_VAE_ATTN_LINEAR_SUFFIXES):
                w = w[:, :, None, None]
            out[f"{key_map[base]}.{suffix}"] = w
    if text_tree is not None:
        out.update({text_prefix + k: v for k, v in pytree.flatten(text_tree).items()})
    return out
