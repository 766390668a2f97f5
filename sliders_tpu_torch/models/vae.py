"""AutoencoderKL (the SD VAE) as functions over a parameter dict
(port of sliders_tpu/models/vae.py): `encode` for image-slider training,
`decode` for serving.

The parameter dict mirrors the diffusers state dict (encoder./decoder./
quant_conv/post_quant_conv) in torch layouts. `scaling_factor` (and FLUX's
`shift_factor`) are applied by callers through `normalize_latents` and
`denormalize_latents`. Every conv casts its weights to the activation's
dtype (`ops/basic.conv2d`), so f32 images encode in f32 whatever dtype the
weights were loaded in.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from sliders_tpu_torch.models.params import ParamFactory
from sliders_tpu_torch.models.unet2d import upsample_nearest2x
from sliders_tpu_torch.ops.attention import multihead_attention
from sliders_tpu_torch.ops.basic import conv2d, group_norm, linear


@dataclass(frozen=True)
class VaeConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: tuple = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    shift_factor: float = 0.0


SD_VAE = VaeConfig()
SDXL_VAE = VaeConfig(scaling_factor=0.13025)
FLUX_VAE = VaeConfig(latent_channels=16, scaling_factor=0.3611, shift_factor=0.1159)
TINY = VaeConfig(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8)
TINY_FLUX = VaeConfig(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8,
                      latent_channels=4, scaling_factor=0.3611, shift_factor=0.1159)


def normalize_latents(cfg: VaeConfig, raw: torch.Tensor) -> torch.Tensor:
    """Posterior sample -> model-space latents: (z - shift) * scale."""
    return (raw - cfg.shift_factor) * cfg.scaling_factor


def denormalize_latents(cfg: VaeConfig, latents: torch.Tensor) -> torch.Tensor:
    return latents / cfg.scaling_factor + cfg.shift_factor


def _resnet(p: dict, x, groups: int):
    h = group_norm(p["norm1"], x, groups, eps=1e-6, silu=True)
    h = conv2d(p["conv1"], h, padding=1)
    h = group_norm(p["norm2"], h, groups, eps=1e-6, silu=True)
    h = conv2d(p["conv2"], h, padding=1)
    if "conv_shortcut" in p:
        x = conv2d(p["conv_shortcut"], x, padding=0)
    return x + h


def _mid_attention(p: dict, x, groups: int):
    """Single-head spatial attention (d = channels: at 512 channels and
    L >= 1024 latent pixels it takes kernel #4, as in the JAX package)."""
    B, H, W, C = x.shape
    residual = x
    h = group_norm(p["group_norm"], x, groups, eps=1e-6).reshape(B, H * W, C)
    q = linear(p["to_q"], h)
    k = linear(p["to_k"], h)
    v = linear(p["to_v"], h)
    h = multihead_attention(q, k, v, num_heads=1)
    return linear(p["to_out"]["0"], h).reshape(B, H, W, C) + residual


def _mid_block(p: dict, x, groups: int):
    x = _resnet(p["resnets"]["0"], x, groups)
    x = _mid_attention(p["attentions"]["0"], x, groups)
    return _resnet(p["resnets"]["1"], x, groups)


def encode(params: dict, cfg: VaeConfig, images: torch.Tensor):
    """images (B, H, W, 3) in [-1, 1], NHWC -> (mean, logvar) of the latent
    posterior, each (B, H/8, W/8, latent_channels), logvar clipped to
    [-30, 20]. The stride-2 and 1x1 convs run on cuDNN; under conv impl
    'auto' the stride-1 3x3 convs take kernel #5, and the mid attention
    (d = channels) takes kernel #4 from L = 1024 latent pixels."""
    enc = params["encoder"]
    g = cfg.norm_num_groups
    h = conv2d(enc["conv_in"], images, padding=1)
    n = len(cfg.block_out_channels)
    for i in range(n):
        bp = enc["down_blocks"][str(i)]
        for j in range(cfg.layers_per_block):
            h = _resnet(bp["resnets"][str(j)], h, g)
        if i < n - 1:
            # diffusers VAE downsample: asymmetric (0, 1, 0, 1) pad of H and
            # W, then a stride-2 conv with no padding
            h = F.pad(h, (0, 0, 0, 1, 0, 1))
            h = conv2d(bp["downsamplers"]["0"]["conv"], h, stride=2, padding=0)
    h = _mid_block(enc["mid_block"], h, g)
    h = group_norm(enc["conv_norm_out"], h, g, eps=1e-6, silu=True)
    h = conv2d(enc["conv_out"], h, padding=1)
    h = conv2d(params["quant_conv"], h, padding=0)
    mean, logvar = h.chunk(2, dim=-1)
    return mean, torch.clamp(logvar, -30.0, 20.0)


def sample_latents(mean: torch.Tensor, logvar: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mean + exp(logvar / 2) * eps, with `eps` given or drawn unit-normal
    from `generator` (on the generator's device, then moved to mean's)."""
    if eps is None:
        device = generator.device if generator is not None else mean.device
        eps = torch.randn(mean.shape, generator=generator, device=device, dtype=mean.dtype)
    std = torch.exp(0.5 * logvar)
    return mean + std * eps.to(device=mean.device, dtype=mean.dtype)


def decode(params: dict, cfg: VaeConfig, latents: torch.Tensor) -> torch.Tensor:
    """latents (B, h, w, latent_channels) -> images (B, 8h, 8w, 3), NHWC."""
    dec = params["decoder"]
    g = cfg.norm_num_groups
    h = conv2d(params["post_quant_conv"], latents, padding=0)
    h = conv2d(dec["conv_in"], h, padding=1)
    h = _mid_block(dec["mid_block"], h, g)
    n = len(cfg.block_out_channels)
    for i in range(n):
        bp = dec["up_blocks"][str(i)]
        for j in range(cfg.layers_per_block + 1):
            h = _resnet(bp["resnets"][str(j)], h, g)
        if i < n - 1:
            h = conv2d(bp["upsamplers"]["0"]["conv"], upsample_nearest2x(h), padding=1)
    h = group_norm(dec["conv_norm_out"], h, g, eps=1e-6, silu=True)
    return conv2d(dec["conv_out"], h, padding=1)


def init_params(
    generator: Optional[torch.Generator], cfg: VaeConfig, dtype=torch.float32, device="cpu"
) -> dict:
    f = ParamFactory(generator, dtype, device)

    def resnet(i, o):
        p = {"norm1": f.norm(i), "conv1": f.conv(i, o), "norm2": f.norm(o), "conv2": f.conv(o, o)}
        if i != o:
            p["conv_shortcut"] = f.conv(i, o, k=1)
        return p

    def mid(c):
        return {
            "resnets": {"0": resnet(c, c), "1": resnet(c, c)},
            "attentions": {
                "0": {
                    "group_norm": f.norm(c),
                    "to_q": f.dense(c, c),
                    "to_k": f.dense(c, c),
                    "to_v": f.dense(c, c),
                    "to_out": {"0": f.dense(c, c)},
                }
            },
        }

    ch = cfg.block_out_channels
    n = len(ch)
    enc_down = {}
    out_c = ch[0]
    for i in range(n):
        in_c, out_c = out_c, ch[i]
        bp = {"resnets": {}}
        for j in range(cfg.layers_per_block):
            bp["resnets"][str(j)] = resnet(in_c if j == 0 else out_c, out_c)
        if i < n - 1:
            bp["downsamplers"] = {"0": {"conv": f.conv(out_c, out_c)}}
        enc_down[str(i)] = bp
    encoder = {
        "conv_in": f.conv(cfg.in_channels, ch[0]),
        "down_blocks": enc_down,
        "mid_block": mid(ch[-1]),
        "conv_norm_out": f.norm(ch[-1]),
        "conv_out": f.conv(ch[-1], 2 * cfg.latent_channels),
    }

    rev = tuple(reversed(ch))
    dec_up = {}
    out_c = rev[0]
    for i in range(n):
        prev_c, out_c = out_c, rev[i]
        bp = {"resnets": {}}
        for j in range(cfg.layers_per_block + 1):
            bp["resnets"][str(j)] = resnet(prev_c if j == 0 else out_c, out_c)
        if i < n - 1:
            bp["upsamplers"] = {"0": {"conv": f.conv(out_c, out_c)}}
        dec_up[str(i)] = bp
    decoder = {
        "conv_in": f.conv(cfg.latent_channels, rev[0]),
        "mid_block": mid(rev[0]),
        "up_blocks": dec_up,
        "conv_norm_out": f.norm(rev[-1]),
        "conv_out": f.conv(rev[-1], cfg.out_channels),
    }
    return {
        "encoder": encoder,
        "decoder": decoder,
        "quant_conv": f.conv(2 * cfg.latent_channels, 2 * cfg.latent_channels, k=1),
        "post_quant_conv": f.conv(cfg.latent_channels, cfg.latent_channels, k=1),
    }
