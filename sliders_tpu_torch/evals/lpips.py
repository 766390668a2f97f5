"""LPIPS (AlexNet) perceptual distance (port of sliders_tpu/evals/lpips.py).

Replaces the reference's `lpips.LPIPS(net='alex')` structural-preservation
gate (eval-scripts/lpip_score.py:44,67): LPIPS between each scale's images
and the scale-0 folder at 64 px. Architecture: torchvision AlexNet feature
taps relu1-5, per-channel unit normalization, squared diff, learned 1x1
non-negative linear weights, spatial mean, sum over taps (Zhang et al. 2018).

Stock PyTorch ops in f32 (`F.conv2d`, `F.max_pool2d`), as the JAX package
runs `lax.conv_general_dilated` and no Pallas kernel. Images are NHWC at
the interface, as there; the features run NCHW. Weights load from local
torch checkpoints (torchvision alexnet + the lpips package's `alex.pth`
linear weights) by `load_torch_weights`; random init for tests and smoke
runs. `load_image_64` reads a PNG with no PIL: `data/native_loader`'s
decoder and its bit-exact copy of PIL's 8-bit bilinear resize.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from sliders_tpu_torch.models.params import tree_to

# lpips input normalization (the package's ScalingLayer constants)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# AlexNet feature stack: (out_ch, kernel, stride, pad), maxpool after 1,2
ALEX_CONVS = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_POOL_AFTER = {0, 1}
# torchvision `alexnet().features` indices of the five convs
_TORCHVISION_CONVS = (0, 3, 6, 8, 10)


def _features_nchw(params: dict, x: torch.Tensor) -> list:
    feats = []
    for i, (_, _, s, p) in enumerate(ALEX_CONVS):
        c = params["convs"][str(i)]
        x = F.relu(F.conv2d(x, c["weight"].float(), c["bias"].float(), stride=s, padding=p))
        feats.append(x)
        if i in _POOL_AFTER:
            x = F.max_pool2d(x, 3, 2)
    return feats


def alexnet_features(params: dict, x: torch.Tensor) -> list:
    """x: (B, H, W, 3) in lpips-normalized space. Returns relu1..relu5,
    each (B, h, w, C)."""
    return [f.permute(0, 2, 3, 1) for f in _features_nchw(params, x.float().permute(0, 3, 1, 2))]


def lpips_distance(params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x, y: (B, H, W, 3) in [-1, 1]. Returns (B,) distances (f32)."""
    shift = torch.tensor(_SHIFT, device=x.device)[:, None, None]
    scale = torch.tensor(_SCALE, device=x.device)[:, None, None]
    fx = _features_nchw(params, (x.float().permute(0, 3, 1, 2) - shift) / scale)
    fy = _features_nchw(params, (y.float().permute(0, 3, 1, 2) - shift) / scale)
    total = 0.0
    for i, (a, b) in enumerate(zip(fx, fy)):
        a = a / (torch.linalg.norm(a, dim=1, keepdim=True) + 1e-10)
        b = b / (torch.linalg.norm(b, dim=1, keepdim=True) + 1e-10)
        w = params["lins"][str(i)]["weight"].float()[None, :, None, None]  # non-negative
        total = total + torch.mean(torch.sum((a - b) ** 2 * w, dim=1), dim=(1, 2))
    return total


def load_torch_weights(alexnet_path: str, lpips_lin_path: str, device="cpu") -> dict:
    """Build f32 params on `device` from local torch checkpoints:
    - `alexnet_path`: torchvision alexnet state_dict (.pth)
    - `lpips_lin_path`: lpips package 'alex.pth' (lin0..lin4 1x1 conv weights)
    """
    alex = torch.load(alexnet_path, map_location="cpu", weights_only=True)
    lins = torch.load(lpips_lin_path, map_location="cpu", weights_only=True)
    convs = {str(i): {"weight": alex[f"features.{idx}.weight"].float(),
                      "bias": alex[f"features.{idx}.bias"].float()}
             for i, idx in enumerate(_TORCHVISION_CONVS)}
    lin_p = {str(i): {"weight": lins[f"lin{i}.model.1.weight"].float()[0, :, 0, 0]}
             for i in range(len(ALEX_CONVS))}
    return tree_to({"convs": convs, "lins": lin_p}, device)


def torchvision_state(params: dict) -> tuple:
    """Inverse of `load_torch_weights`: (the torchvision alexnet
    `features.N.*` entries, the lpips `lin{i}.model.1.weight` entries), CPU
    tensors in the checkpoints' layouts."""
    alex = {}
    for i, idx in enumerate(_TORCHVISION_CONVS):
        c = params["convs"][str(i)]
        alex[f"features.{idx}.weight"] = c["weight"].detach().cpu().contiguous()
        alex[f"features.{idx}.bias"] = c["bias"].detach().cpu()
    lins = {f"lin{i}.model.1.weight": params["lins"][str(i)]["weight"].detach().cpu()
            [None, :, None, None].clone() for i in range(len(ALEX_CONVS))}
    return alex, lins


def init_params(generator: Optional[torch.Generator], device="cpu") -> dict:
    """Random init with the real architecture and the JAX package's
    distributions (tests / smoke only: not a perceptual metric without
    trained weights)."""
    convs, lins = {}, {}
    in_c = 3
    for i, (out_c, k, _, _) in enumerate(ALEX_CONVS):
        w = torch.randn((out_c, in_c, k, k), generator=generator) * (in_c * k * k) ** -0.5
        convs[str(i)] = {"weight": w, "bias": torch.zeros(out_c)}
        lins[str(i)] = {"weight": torch.randn(out_c, generator=generator).abs() * 0.1}
        in_c = out_c
    return tree_to({"convs": convs, "lins": lins}, device)


def load_image_64(path: str) -> torch.Tensor:
    """Reference loader contract (lpip_score.py:22-33): shortest side -> 64
    (PIL's 8-bit bilinear), to [-1, 1]: (1, h, w, 3) f32 on the CPU."""
    from sliders_tpu_torch.data.native_loader import decode_file, resize_bilinear_pil

    img = decode_file(path)
    h, w = img.shape[:2]
    if w < h:
        nw, nh = 64, round(h * 64 / w)
    else:
        nw, nh = round(w * 64 / h), 64
    if (nw, nh) != (w, h):
        img = resize_bilinear_pil(img, nw, nh)
    arr = img.astype(np.float32) / np.float32(255.0)
    return torch.from_numpy((arr - np.float32(0.5)) * np.float32(2.0))[None]
