"""The port's single-file LDM checkpoints (`models/ldm_checkpoint.py` and
`loader.load_sd`'s dispatch) on the CPU at TINY sizes: exact round trips
through the inverse key map, the key map's coverage, `.safetensors` and
`.ckpt` files, the loader against a snapshot of the same weights, and the
JAX converter on the same numpy-made LDM state (bit for bit through
`from_jax_params`), with the UNet on the golden probe against JAX's
`unet2d.apply` in f32 (atol 1e-5 times max(1, max|JAX|), as
tests/test_torch_models.py holds the UNet)."""

import dataclasses
import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from torch_tiny_snapshot import write_tiny_snapshot

from sliders_tpu.models import ldm_checkpoint as jldm
from sliders_tpu.models import unet2d as junet
from sliders_tpu.models import vae as jvae
from sliders_tpu_torch.models import clip_text, convert, loader, unet2d, vae
from sliders_tpu_torch.models import ldm_checkpoint as ldm
from sliders_tpu_torch.models.convert import from_jax_params, write_safetensors
from sliders_tpu_torch.utils import pytree
from sliders_tpu_torch.utils.goldens import fixed_unet_probe, unet_on_probe


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny tensors gain nothing from torch's thread pool, and beside the
    other test workers its threads oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_trees_equal(a: dict, b: dict):
    fa, fb = pytree.flatten(a), pytree.flatten(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k
        if fa[k].ndim == 4:
            assert fa[k].is_contiguous(memory_format=torch.channels_last), k


def _numpy_ldm_state(seed: int = 0) -> dict:
    """A complete TINY LDM state (UNet, VAE with 1x1-conv attention, CLIP
    text with position_ids) drawn with numpy: weights ~ N(0, fan_in^-1),
    biases ~ 0.1 N(0, 1), norm scales 1 + 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    meta = ldm.to_ldm_state(
        unet2d.init_params(None, unet2d.TINY, device="meta"), unet2d.TINY,
        vae.init_params(None, vae.TINY, device="meta"), vae.TINY,
        clip_text.init_params(None, clip_text.TINY, device="meta"))
    state = {}
    for k, w in meta.items():
        shape = tuple(w.shape)
        if k.endswith(".bias"):
            v = 0.1 * rng.standard_normal(shape)
        elif len(shape) == 1:
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            v = rng.standard_normal(shape) * np.prod(shape[1:]) ** -0.5
        state[k] = v.astype(np.float32)
    state[ldm.TEXT_PREFIX + "text_model.embeddings.position_ids"] = np.arange(
        clip_text.TINY.max_positions)[None]
    return state


def test_unet_and_vae_round_trip_exact():
    gen = torch.Generator().manual_seed(0)
    unet_tree = unet2d.init_params(gen, unet2d.TINY)
    vae_tree = vae.init_params(gen, vae.TINY)
    state = ldm.to_ldm_state(unet_tree, unet2d.TINY, vae_tree, vae.TINY)
    assert all(k.startswith(("model.diffusion_model.", "first_stage_model.")) for k in state)
    assert state["first_stage_model.decoder.mid.attn_1.q.weight"].ndim == 4
    u, v, t = ldm.convert_ldm_state(state, unet2d.TINY, vae.TINY)
    assert t is None
    _assert_trees_equal(u, unet_tree)
    _assert_trees_equal(v, vae_tree)


@pytest.mark.parametrize("cfg", [unet2d.TINY_XL, unet2d.SD15, unet2d.SD21, unet2d.SDXL],
                         ids=["tiny_xl", "sd15", "sd21", "sdxl"])
def test_key_map_covers_every_parameter(cfg):
    """Every parameter has an LDM key (TINY_XL's text_time label_emb too),
    and the map is one to one."""
    key_map = ldm.diffusers_to_ldm_keys(cfg)
    assert len(set(key_map.values())) == len(key_map)
    for path in pytree.flatten(unet2d.init_params(None, cfg, device="meta")):
        assert path.rpartition(".")[0] in key_map, path
    assert ("add_embedding.linear_1" in key_map) == (cfg.addition_embed_type == "text_time")
    # the port's key pairs are the JAX package's
    assert key_map == jldm.diffusers_to_ldm_keys(junet.get_config(
        {unet2d.TINY_XL: "tiny_xl", unet2d.SD15: "sd15", unet2d.SD21: "sd21",
         unet2d.SDXL: "sdxl"}[cfg]))


def test_text_passthrough_drops_position_ids():
    text = clip_text.init_params(torch.Generator().manual_seed(1), clip_text.TINY)
    state = ldm.to_ldm_state({}, unet2d.TINY, text_tree=text)
    state[ldm.TEXT_PREFIX + "text_model.embeddings.position_ids"] = torch.arange(16)[None]
    u, v, t = ldm.convert_ldm_state(state, unet2d.TINY, vae.TINY)
    assert u is None and v is None
    _assert_trees_equal(t, text)


def test_numpy_state_matches_the_jax_converter_and_unet():
    """The same numpy-made LDM state through both converters gives equal
    trees bit for bit; the port's UNet on its golden probe matches JAX's."""
    state = _numpy_ldm_state()
    ju, jv, jt = jldm.convert_ldm_state(state, junet.TINY, jvae.TINY)
    tu, tv, tt = ldm.convert_ldm_state({k: torch.from_numpy(v) for k, v in state.items()},
                                       unet2d.TINY, vae.TINY)
    for j, t in ((ju, tu), (jv, tv)):
        _assert_trees_equal(t, from_jax_params(j))
    # the text tree keeps the state's layout in both (position_ids dropped)
    jt_flat, tt_flat = pytree.flatten(jt), pytree.flatten(tt)
    assert set(jt_flat) == set(tt_flat) and not any("position_ids" in k for k in tt_flat)

    probe = fixed_unet_probe(unet2d.TINY, spatial=8, tokens=7)
    out = unet_on_probe(tu, unet2d.TINY, probe)
    # jitted: one XLA compile instead of one per primitive (1.8 s against 10.8)
    apply = jax.jit(lambda p, x, t, e: junet.apply(p, junet.TINY, x, t, e))
    ref = np.asarray(apply(ju, probe["x"], probe["t"], probe["ehs"]))
    assert out.shape == ref.shape and np.isfinite(ref).all()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("suffix", [".safetensors", ".ckpt"])
def test_single_files(tmp_path, suffix):
    """Both file kinds give the in-memory conversion's trees; a .ckpt wraps
    its tensors in 'state_dict' beside non-tensor entries, and loads in f32."""
    gen = torch.Generator().manual_seed(2)
    unet_tree = unet2d.init_params(gen, unet2d.TINY)
    vae_tree = vae.init_params(gen, vae.TINY)
    text = clip_text.init_params(gen, clip_text.TINY)
    state = ldm.to_ldm_state(unet_tree, unet2d.TINY, vae_tree, vae.TINY, text)
    path = str(tmp_path / f"sd{suffix}")
    if suffix == ".safetensors":
        write_safetensors(path, {k: v.to(torch.bfloat16) for k, v in state.items()})
    else:
        torch.save({"state_dict": {k: v.to(torch.bfloat16) for k, v in state.items()},
                    "global_step": 7}, path)
    u, v, t = ldm.load_single_file(path, unet2d.TINY, vae.TINY)
    want = torch.bfloat16 if suffix == ".safetensors" else torch.float32
    for got, ref in ((u, unet_tree), (v, vae_tree), (t, text)):
        ref = {p: w.to(torch.bfloat16).to(want) for p, w in pytree.flatten(ref).items()}
        _assert_trees_equal(got, pytree.unflatten(ref))


def _write_single_file(snap: str, path: str, text_prefix: str = ldm.TEXT_PREFIX) -> None:
    """The snapshot's UNet, VAE and text encoder as one LDM `.safetensors`."""
    state = ldm.to_ldm_state(convert.load_component(snap, "unet"), unet2d.TINY,
                             convert.load_component(snap, "vae"), vae.TINY,
                             convert.load_component(snap, "text_encoder"), text_prefix)
    write_safetensors(path, state)


@pytest.fixture(scope="module")
def tiny_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("ldm")
    snap = write_tiny_snapshot(root / "sd_tiny")
    single = str(root / "sd.safetensors")
    _write_single_file(snap, single)
    te_cfg = loader.clip_config_from_hf(convert.load_component_config(snap, "text_encoder"))
    return snap, single, te_cfg


def test_loader_single_file_equals_snapshot(tiny_files):
    """SD1: load_sd on the single file (configs patched to TINY) returns the
    snapshot load's trees bit for bit; v2 picks SD21 and the 24-layer
    CLIP_SD2 with clip_skip 2 (23 layers kept), as the JAX loader does."""
    snap, single, te_cfg = tiny_files
    ref = loader.load_sd(snap, dtype=torch.float32, load_vae=True)
    with mock.patch.object(unet2d, "SD15", unet2d.TINY), \
            mock.patch.object(vae, "SD_VAE", vae.TINY), \
            mock.patch.object(clip_text, "CLIP_L", te_cfg):
        m = loader.load_sd(single, dtype=torch.float32, load_vae=True,
                           tokenizer_dir=os.path.join(snap, "tokenizer"))
        no_vae = loader.load_sd(single, dtype=torch.float32,
                                tokenizer_dir=os.path.join(snap, "tokenizer"))
    assert m.unet_config is unet2d.TINY and m.vae_config is vae.TINY and not m.is_xl
    assert no_vae.vae_params is None and no_vae.vae_config is None
    _assert_trees_equal(m.unet_params, ref.unet_params)
    _assert_trees_equal(m.vae_params, ref.vae_params)
    _assert_trees_equal(m.text_encoders[0].params, ref.text_encoders[0].params)
    assert m.text_encoders[0].clip_skip_layers is None
    assert (m.text_encoders[0].tokenizer(["old person"]) ==
            ref.text_encoders[0].tokenizer(["old person"])).all()

    v2_cfg = dataclasses.replace(unet2d.TINY)  # a distinct copy: SD21 patched to TINY
    sd2_te = dataclasses.replace(te_cfg, hidden_act="gelu")
    with mock.patch.object(unet2d, "SD21", v2_cfg), \
            mock.patch.object(clip_text, "CLIP_SD2", sd2_te):
        m2 = loader.load_sd(single, v2=True, dtype=torch.float32,
                            tokenizer_dir=os.path.join(snap, "tokenizer"))
    ref2 = loader.load_sd(snap, v2=True, dtype=torch.float32)
    assert m2.unet_config is v2_cfg
    te = m2.text_encoders[0]
    assert te.config == dataclasses.replace(sd2_te, num_layers=24) and te.clip_skip_layers == 23
    _assert_trees_equal(m2.unet_params, ref2.unet_params)
    _assert_trees_equal(te.params, ref2.text_encoders[0].params)


def test_loader_single_file_errors(tiny_files, tmp_path):
    """No tokenizer_dir, or no text weights under cond_stage_model.transformer.
    (SD2's OpenCLIP files use cond_stage_model.model.): the JAX loader's
    ValueErrors."""
    snap, single, _ = tiny_files
    with pytest.raises(ValueError, match="tokenizer_dir"):
        loader.load_sd(single, dtype=torch.float32)
    openclip = str(tmp_path / "sd2.safetensors")
    _write_single_file(snap, openclip, text_prefix="cond_stage_model.model.")
    with mock.patch.object(unet2d, "SD15", unet2d.TINY):
        with pytest.raises(ValueError, match="missing UNet or text-encoder weights"):
            loader.load_sd(openclip, tokenizer_dir=os.path.join(snap, "tokenizer"))
