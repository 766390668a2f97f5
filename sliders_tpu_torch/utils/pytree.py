"""Dotted-path <-> nested-dict parameter tree helpers.

Parameter trees are nested dicts whose joined keys reproduce the diffusers /
transformers state-dict paths (e.g.
``down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight``).
"""

from __future__ import annotations

from typing import Any


def flatten(tree: dict, prefix: str = "", sep: str = ".") -> dict[str, Any]:
    """Flatten a nested dict into {dotted_path: leaf}."""
    out: dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, path, sep))
        else:
            out[path] = v
    return out


def unflatten(flat: dict[str, Any], sep: str = ".") -> dict:
    """Invert :func:`flatten`."""
    tree: dict = {}
    for path, leaf in flat.items():
        parts = path.split(sep)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree
