"""Weights into the port: diffusers snapshots and JAX parameter trees
(counterpart of sliders_tpu/models/convert.py).

The port keeps torch layouts ((out, in) linears, OIHW convs), so a diffusers
state dict needs no transposes, only nesting (`convert_state_dict`).
`from_jax_params` carries a JAX parameter tree with numpy leaves over, doing
every transpose once:
  - linear (in, out) -> (out, in); conv HWIO -> OIHW;
  - LoRA factors: linear down (in, r) -> (r, in), up (r, out) -> (out, r);
    conv down (kh, kw, in, r) -> (r, in, kh, kw), up (1, 1, r, out) ->
    (out, r, 1, 1); per-row stacked trees keep their leading row axis.

`read_safetensors` reads the public `.safetensors` format with no package
beyond torch: an 8-byte little-endian header length, a JSON header, then the
raw little-endian tensor bytes. `write_safetensors` is its inverse.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Mapping, Optional

import numpy as np
import torch

from sliders_tpu_torch.models.params import tree_to
from sliders_tpu_torch.utils import pytree

# 2-D weights that are NOT linear layers (stored (rows, cols) in both layouts):
# CLIP's two embeddings, T5's token embedding (and its tied copy) and T5's
# relative position table
_EMBEDDING_SUFFIXES = (
    "token_embedding.weight",
    "position_embedding.weight",
    "shared.weight",
    "embed_tokens.weight",
    "relative_attention_bias.weight",
)

_ST_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}


_ST_NAMES = {dtype: name for name, dtype in _ST_DTYPES.items()}


def is_embedding_path(path: str) -> bool:
    return path.endswith(_EMBEDDING_SUFFIXES)


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of a `.safetensors` file, on the CPU."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        f.readinto(data)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        begin, end = info["data_offsets"]
        shape = info["shape"]
        if begin == end:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        flat = torch.frombuffer(data, dtype=dtype, count=(end - begin) // dtype.itemsize,
                                offset=begin)
        out[name] = flat.reshape(shape)
    return out


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor],
                      metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write `tensors` (any device) as a `.safetensors` file: the header is
    JSON padded with spaces to a multiple of 8 bytes, the data follows in
    name order with no gaps. `metadata` values must be strings."""
    names = sorted(tensors)
    header: dict = {}
    if metadata:
        if not all(isinstance(v, str) for v in metadata.values()):
            raise ValueError("safetensors metadata values must be strings")
        header["__metadata__"] = dict(metadata)
    blobs, offset = [], 0
    for name in names:
        t = tensors[name].detach()
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"tensor {name!r} has unsupported dtype {t.dtype}")
        data = t.to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for data in blobs:
            f.write(data)
    os.replace(tmp, path)


def convert_state_dict(state: Mapping[str, torch.Tensor]) -> dict:
    """torch-layout flat state dict -> nested parameter dict (no transposes)."""
    return pytree.unflatten(dict(state))


def _jax_weight_to_torch(path: str, w: np.ndarray) -> np.ndarray:
    if path.endswith(".weight") and not is_embedding_path(path):
        if w.ndim == 2:
            return w.T
        if w.ndim == 4:
            return w.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    return w


_LORA_AXES = {
    # (factor, ndim) -> numpy transpose; 3/5-D are per-row stacked factors
    ("down", 2): (1, 0),
    ("up", 2): (1, 0),
    ("down", 3): (0, 2, 1),
    ("up", 3): (0, 2, 1),
    ("down", 4): (3, 2, 0, 1),
    ("up", 4): (3, 2, 0, 1),
    ("down", 5): (0, 4, 3, 1, 2),
    ("up", 5): (0, 4, 3, 1, 2),
}


def _is_slider_tree(tree: dict) -> bool:
    return bool(tree) and all(isinstance(v, dict) and "down" in v and "up" in v
                              for v in tree.values())


def _tensor(w) -> torch.Tensor:
    return torch.from_numpy(np.array(w, dtype=np.float32, order="C"))


def from_jax_params(tree: dict) -> dict:
    """A JAX parameter tree with numpy leaves -> the port's parameters (f32).

    Model trees (UNet, CLIP, VAE, FLUX, T5) get their linear/conv weights
    transposed to torch layouts (embeddings stay as they are), conv weights
    laid out channels_last as `params.tree_to` lays them out. A slider tree
    ({lora_name: {down, up, alpha[, rank]}}, solo or per-row stacked) gets
    its factors transposed the same way."""
    if _is_slider_tree(tree):
        out = {}
        for name, entry in tree.items():
            conv = {}
            for k, w in entry.items():
                w = np.asarray(w)
                if k in ("down", "up"):
                    w = w.transpose(_LORA_AXES[(k, w.ndim)])
                conv[k] = _tensor(w)
            out[name] = conv
        return out
    flat = pytree.flatten(tree)
    return tree_to(pytree.unflatten({p: _tensor(_jax_weight_to_torch(p, np.asarray(w)))
                                     for p, w in flat.items()}))


def _component_files(component_dir: str) -> list[str]:
    """All model safetensors shards in a diffusers component directory."""
    for idx in ("diffusion_pytorch_model.safetensors.index.json", "model.safetensors.index.json"):
        path = os.path.join(component_dir, idx)
        if os.path.exists(path):
            with open(path) as f:
                shards = sorted(set(json.load(f)["weight_map"].values()))
            return [os.path.join(component_dir, s) for s in shards]
    files = [
        os.path.join(component_dir, f)
        for f in sorted(os.listdir(component_dir))
        if f.endswith(".safetensors")
    ]
    if not files:
        raise FileNotFoundError(f"no safetensors in {component_dir}")
    return files


def load_component(model_dir: str, subfolder: str) -> dict:
    """One pipeline component ('unet', 'text_encoder', 'vae') of a local
    diffusers snapshot -> nested parameter dict on the CPU."""
    state: dict[str, torch.Tensor] = {}
    for path in _component_files(os.path.join(model_dir, subfolder)):
        state.update(read_safetensors(path))
    return convert_state_dict(state)


def load_component_config(model_dir: str, subfolder: str) -> dict:
    path = os.path.join(model_dir, subfolder, "config.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no config.json under {model_dir}/{subfolder}")
    with open(path) as f:
        return json.load(f)
