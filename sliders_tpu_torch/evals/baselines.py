"""Baseline methods the reference eval harness compares sliders against
(port of sliders_tpu/evals/baselines.py; SURVEY.md §2.4).

- UCE (unified concept editing): full-model weight-delta interpolation
  `old + scale * (edited - old)` per slider scale, swapped in mid-sampling
  at the start_noise boundary (eval-scripts/generate_images-uce.py:106-111,
  193-215): `make_uce_sampling_fn` runs `text2image.make_sampling_fn`'s
  loop, whose gated steps take the interpolated tree, formed once a call.

- Textual inversion: a learned token embedding injected into the prompt
  (eval-scripts/generate_images_textinversion.py:20-36): the learned
  vector(s) are written into the token-embedding matrix under a
  placeholder id. The XL variant writes the {'emb','emb2'} pair into BOTH
  encoders (eval-scripts/generate_images_textinversion_xl.py:9-27).

- Custom diffusion: a delta checkpoint holding fine-tuned attn2 projections
  (K/V for 'crossattn_kv', all of attn2 for 'crossattn', optionally
  low-rank-compressed as additive u@v) plus modifier-token embeddings for
  both encoders, added as NEW tokens to both tokenizers
  (eval-scripts/generate_images_customdiffusion.py:688-785 load_model).

Parameter trees keep torch layouts, so a torch checkpoint's tensors go in
without transposes; each new leaf takes the dtype, device and layout of the
leaf it replaces. Checkpoints are read with `torch.load(weights_only=True)`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sliders_tpu_torch.diffusion.schedulers import Sampler
from sliders_tpu_torch.models import unet2d
from sliders_tpu_torch.utils import pytree

TOKEN_EMBEDDING = "text_model.embeddings.token_embedding.weight"


def _like(new, old: torch.Tensor) -> torch.Tensor:
    """`new` (a tensor or an array) in the dtype, device and layout of
    `old`: cast from f32 as the JAX package's jnp.asarray(new, old.dtype)."""
    t = torch.as_tensor(new)
    fmt = torch.channels_last if t.ndim == 4 else torch.preserve_format
    return t.to(dtype=old.dtype, device=old.device, memory_format=fmt)


def interpolate_params(old: dict, edited: dict, scale) -> dict:
    """UCE per-scale model: old + scale * (edited - old), leafwise, in f32,
    each leaf cast back to its dtype."""
    out = {}
    for k, a in old.items():
        if isinstance(a, dict):
            out[k] = interpolate_params(a, edited[k], scale)
            continue
        af = a.float()
        out[k] = (af + scale * (edited[k].float() - af)).to(a.dtype)
    return out


def make_uce_sampling_fn(unet_cfg: unet2d.UNetConfig, sampler: Sampler, *,
                         compute_dtype=torch.bfloat16):
    """fn(old_params, edited_params, latents, cond, uncond, scale,
    start_noise, guidance_scale, generator=None, step_noise=None) -> latents:
    the base weights at the steps before the first i with timesteps[i] <=
    start_noise (all of them if there is none), the scale-interpolated
    weights from it on (the reference's state_dict swap). The CFG loop is
    `make_sampling_fn`'s with no adapter; `generator` / `step_noise` are the
    ancestral samplers' draws."""
    from sliders_tpu_torch.pipelines.text2image import make_sampling_fn

    sample = make_sampling_fn(unet_cfg, sampler, compute_dtype=compute_dtype)

    def fn(old_params, edited_params, latents, cond, uncond, scale, start_noise,
           guidance_scale, generator: Optional[torch.Generator] = None, step_noise=None):
        return sample(old_params, latents, cond, uncond, None, 0.0, float(start_noise),
                      guidance_scale, generator=generator, step_noise=step_noise,
                      gated_params=lambda: interpolate_params(old_params, edited_params,
                                                              float(scale)))

    return fn


def load_uce_unet(checkpoint_path: str, old_params: dict) -> dict:
    """Ingest a UCE-edited torch UNet state_dict (.pt) into a tree shaped
    like `old_params` (the reference consumes full diffusers-UNet state
    dicts saved by the UCE editing code, generate_images-uce.py:193-215):
    every leaf of `old_params` is taken from the file (f32, then cast to
    the old leaf's dtype); a missing one raises KeyError; extra entries are
    ignored."""
    state = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    old_flat = pytree.flatten(old_params)
    missing = set(old_flat) - set(state)
    if missing:
        raise KeyError(f"UCE checkpoint is missing {len(missing)} UNet params, e.g. "
                       f"{sorted(missing)[:3]}")
    return pytree.unflatten({k: _like(state[k].float(), o) for k, o in old_flat.items()})


def apply_custom_diffusion(unet_params: dict, state: dict, compress: bool = False) -> dict:
    """Custom-diffusion baseline UNet deltas
    (eval-scripts/generate_images_customdiffusion.py:781-785): fine-tuned
    attn2 projections loaded over the base UNet — K/V for the
    'crossattn_kv' freeze mode, all attn2 params for 'crossattn'. With
    `compress`, to_k/to_v entries are {'u','v'} low-rank factors applied
    ADDITIVELY: param += u @ v (the product in f32 numpy, as the JAX
    package forms it).

    `state`: flat dict of torch-layout weights keyed like
    'down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k.weight'
    (any 'unet.' prefix is stripped)."""
    out = dict(pytree.flatten(unet_params))
    n = 0
    for k, w in state.items():
        k = k.removeprefix("unet.")
        if "attn2" not in k:
            continue
        if k not in out:
            raise KeyError(f"custom-diffusion weight {k} not in UNet")
        cur = out[k]
        if isinstance(w, dict):
            if not compress:
                raise TypeError(f"{k}: a low-rank {{'u','v'}} entry needs compress=True")
            delta = _numpy(w["u"]) @ _numpy(w["v"])
            out[k] = cur + _like(delta, cur)
        else:
            out[k] = _like(w, cur)
        n += 1
    if n == 0:
        raise ValueError("no attn2 weights found in the checkpoint")
    return pytree.unflatten(out)


def _numpy(w) -> np.ndarray:
    return w.float().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)


def apply_full_text_encoder(te_params: dict, state: dict) -> dict:
    """Replace a text encoder's params with a checkpoint's full state dict —
    the reference's `self.text_encoder.load_state_dict(st['text_encoder'])`
    (generate_images_customdiffusion.py:750-752). The token-embedding
    matrix may be LARGER than the base encoder's (saved after add_tokens) —
    the whole resized matrix is taken. Missing or unknown params raise
    KeyError (strict load, like torch's), another shape ValueError;
    non-param buffers (position_ids) are ignored."""
    edited = {k: torch.as_tensor(v).float() for k, v in state.items()
              if not k.endswith("position_ids")}  # buffer, not a param
    old = pytree.flatten(te_params)
    missing = set(old) - set(edited)
    if missing:
        raise KeyError(f"text-encoder state dict is missing {len(missing)} params, "
                       f"e.g. {sorted(missing)[:3]}")
    unknown = set(edited) - set(old)
    if unknown:
        raise KeyError(f"text-encoder state dict has {len(unknown)} unknown params, "
                       f"e.g. {sorted(unknown)[:3]}")
    out = {}
    for k, o in old.items():
        new = edited[k]
        resized = (k.endswith("token_embedding.weight") and new.ndim == 2
                   and new.shape[0] >= o.shape[0] and new.shape[1] == o.shape[1])
        if not resized and tuple(new.shape) != tuple(o.shape):
            raise ValueError(f"text-encoder param {k} shape {tuple(new.shape)} != "
                             f"{tuple(o.shape)}")
        out[k] = _like(new, o)
    return pytree.unflatten(out)


def resize_token_embeddings(te_params: dict, new_size: int) -> dict:
    """Grow the token-embedding matrix to `new_size` rows (new rows zero) —
    text_encoder.resize_token_embeddings after tokenizer.add_tokens
    (generate_images_customdiffusion.py:769-772)."""
    flat = dict(pytree.flatten(te_params))
    emb = flat[TOKEN_EMBEDDING]
    if new_size < emb.shape[0]:
        raise ValueError(f"cannot shrink embeddings {emb.shape[0]} -> {new_size}")
    if new_size > emb.shape[0]:
        pad = emb.new_zeros((new_size - emb.shape[0], emb.shape[1]))
        flat[TOKEN_EMBEDDING] = torch.cat([emb, pad])
    return pytree.unflatten(flat)


def inject_learned_token(te_params: dict, learned_embeddings, token_ids: list) -> dict:
    """Textual-inversion baseline: write learned vectors (one (D,) or (n, D))
    into the token embedding rows `token_ids`, cast to the matrix's dtype."""
    flat = dict(pytree.flatten(te_params))
    emb = flat[TOKEN_EMBEDDING].clone()
    learned = torch.as_tensor(learned_embeddings)
    if learned.ndim == 1:
        learned = learned[None]
    emb[torch.as_tensor(token_ids, device=emb.device)] = learned.to(emb.device, emb.dtype)
    flat[TOKEN_EMBEDDING] = emb
    return pytree.unflatten(flat)


def inject_learned_token_xl(te_params_list: list, tokenizers: list, emb_dict: dict,
                            token: str = "my") -> list:
    """XL textual-inversion baseline: write the learned {'emb','emb2'} pair
    into BOTH encoders' embedding rows for `token`
    (eval-scripts/generate_images_textinversion_xl.py:9-27 set_XLembedding).
    `token` must already be a single token in both tokenizers."""
    out = []
    for i, (tok, te_params) in enumerate(zip(tokenizers, te_params_list)):
        ids = tok.tokenize(token)
        if len(ids) != 1:
            raise ValueError(f"token {token!r} is not a single token in tokenizer {i}")
        emb = torch.as_tensor(_numpy(emb_dict["emb" if i == 0 else "emb2"]))
        out.append(inject_learned_token(te_params, emb, [int(ids[0])]))
    return out


def load_custom_diffusion(checkpoint_path: str, unet_params: dict, tokenizers: list,
                          te_params_list: list, compress: bool = False) -> tuple:
    """Full custom-diffusion checkpoint load: the runnable composition of
    attn2 deltas + modifier tokens the reference's `load_model` performs
    (generate_images_customdiffusion.py:749-785).

    The delta dict (torch.save format) holds:
      'unet': {param_name: tensor | {'u','v'}} attn2 deltas;
      'modifier_token': {token: [emb_for_encoder1, emb_for_encoder2, ...]};
      optionally 'text_encoder'/'text_encoder_2' full state dicts, applied
      as whole-encoder replacements BEFORE the modifier-token handling
      (the reference's load order, :750-752).

    Mutates the tokenizers (add_tokens) and returns
    (new_unet_params, new_te_params_list)."""
    st = torch.load(checkpoint_path, map_location="cpu", weights_only=True)

    te_params_list = list(te_params_list)
    if "text_encoder" in st:
        te_params_list[0] = apply_full_text_encoder(te_params_list[0], st["text_encoder"])
        if "text_encoder_2" in st:
            if len(te_params_list) < 2:
                raise ValueError("checkpoint carries text_encoder_2 but the pipeline has one "
                                 "text encoder (XL checkpoint on an SD1 base?)")
            te_params_list[1] = apply_full_text_encoder(te_params_list[1],
                                                        st["text_encoder_2"])
    for token, embs in st.get("modifier_token", {}).items():
        for i, tok in enumerate(tokenizers):
            if tok.add_tokens(token) == 0:
                raise ValueError(f"tokenizer already contains {token!r}")
            tid = tok.convert_tokens_to_ids(token)
            te_params_list[i] = resize_token_embeddings(te_params_list[i], len(tok))
            te_params_list[i] = inject_learned_token(te_params_list[i], embs[i].float(), [tid])

    unet_state = {k: (v if isinstance(v, dict) else v.float())
                  for k, v in st.get("unet", {}).items()}
    if unet_state:
        unet_params = apply_custom_diffusion(unet_params, unet_state, compress=compress)
    return unet_params, te_params_list
