"""The port's eval baselines (evals/baselines.py) against sliders_tpu's on
the CPU. The loaders, the injections and `interpolate_params` are held
bit for bit (f32, and bf16 where the tree is bf16): the port's trees
against the JAX package's carried over by `from_jax_params`, whose
transposes are exact. The error types of the missing, unknown, shrink and
duplicate cases are the JAX package's. `make_uce_sampling_fn` on the TINY
UNet in f32, under DDIM and LMS, with start_noise below, inside and above
the schedule and at scales -1, 0 and 1 on injected latents: within 1e-5 of
max|x| (the same operations up to the matmuls' and convs' sums); at scale
0 the interpolated tree is the base tree, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers import make_tiny_snapshot

from sliders_tpu.diffusion import make_sampler as jmake_sampler
from sliders_tpu.diffusion import make_schedule as jmake_schedule
from sliders_tpu.evals import baselines as jb
from sliders_tpu.models import convert as jconvert
from sliders_tpu.models import loader as jloader
from sliders_tpu.models import unet2d as junet
from sliders_tpu_torch.diffusion import make_sampler, make_schedule
from sliders_tpu_torch.evals import baselines as tb
from sliders_tpu_torch.models import loader, unet2d
from sliders_tpu_torch.models.convert import from_jax_params
from sliders_tpu_torch.pipelines import text2image as t2i
from sliders_tpu_torch.utils import pytree

KEY = "text_model.embeddings.token_embedding.weight"


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.float32)), tree)


def _equal_trees(port: dict, jax_tree: dict, dtype=torch.float32):
    """The port's tree equals the JAX tree in torch layouts, leaf for leaf
    and bit for bit, every leaf in `dtype`."""
    want = pytree.flatten(from_jax_params(_np(jax_tree)))
    got = pytree.flatten(port)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == dtype, k
        assert torch.equal(got[k].float(), w), k


@pytest.fixture(scope="module")
def xl(tmp_path_factory):
    return make_tiny_snapshot(str(tmp_path_factory.mktemp("baselines") / "sdxl"), xl=True)


@pytest.fixture(scope="module")
def sd_unet():
    """The TINY UNet's JAX parameters as f32 numpy leaves."""
    return _np(junet.init_params(jax.random.key(0), junet.TINY))


def _tes(snap, dtype):
    """(JAX bundles, port bundles) of the snapshot's two text encoders."""
    jm = jloader.load_sdxl(snap, dtype={torch.float32: jnp.float32,
                                        torch.bfloat16: jnp.bfloat16}[dtype])
    tm = loader.load_sdxl(snap, dtype=dtype)
    return jm, tm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_interpolate_params_bit_equal(dtype):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    rng = np.random.default_rng(0)
    old = {"a": {"w": rng.standard_normal((7, 5)).astype(np.float32)},
           "b": rng.standard_normal((4, 3, 3, 3)).astype(np.float32)}
    new = jax.tree.map(lambda x: x + rng.standard_normal(x.shape).astype(np.float32), old)
    j_old, j_new = (jax.tree.map(lambda x: jnp.asarray(x, jdt), t) for t in (old, new))
    t_old, t_new = (jax.tree.map(lambda x: torch.from_numpy(x).to(dtype), t)
                    for t in (old, new))
    for scale in (-2.0, -1.0, -0.5, 0.0, 0.3, 0.5, 1.0, 2.0):
        want = jb.interpolate_params(j_old, j_new, scale)
        got = tb.interpolate_params(t_old, t_new, scale)
        for k in ("a.w", "b"):
            g, w = pytree.flatten(got)[k], pytree.flatten(want)[k]
            assert g.dtype == dtype
            np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))
    zero = tb.interpolate_params(t_old, t_new, 0.0)
    assert torch.equal(zero["a"]["w"], t_old["a"]["w"]) and torch.equal(zero["b"], t_old["b"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_load_uce_unet_bit_equal(tmp_path, sd_unet, dtype):
    """A UCE-edited diffusers UNet state dict (.pt, with an extra entry the
    loader ignores) into the base tree's dtypes; a missing parameter raises
    KeyError in both packages."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jparams = sd_unet
    state = {k: torch.from_numpy(np.ascontiguousarray(v) + np.float32(0.0371))
             for k, v in jconvert.to_torch_layout(jparams).items()}
    torch.save({**state, "extra.buffer": torch.ones(3)}, tmp_path / "uce.pt")
    j_old = jax.tree.map(lambda x: jnp.asarray(x, jdt), jparams)
    t_old = jax.tree.map(lambda x: x.to(dtype), from_jax_params(_np(jparams)))
    want = jb.load_uce_unet(str(tmp_path / "uce.pt"), j_old)
    got = tb.load_uce_unet(str(tmp_path / "uce.pt"), t_old)
    _equal_trees(got, want, dtype)
    conv = got["conv_in"]["weight"]
    assert conv.is_contiguous(memory_format=torch.channels_last)
    torch.save({k: v for k, v in state.items() if k != "conv_in.bias"}, tmp_path / "bad.pt")
    for load, old in ((jb.load_uce_unet, j_old), (tb.load_uce_unet, t_old)):
        with pytest.raises(KeyError, match="missing 1 UNet params"):
            load(str(tmp_path / "bad.pt"), old)


def test_apply_custom_diffusion_bit_equal(xl):
    """Full K/V weights, a bias, and {'u','v'} factors added with
    `compress` over the TINY_XL UNet; a weight not in the UNet (KeyError)
    and a state with no attn2 entry (ValueError) in both packages."""
    jparams = jloader.load_sdxl(xl, dtype=jnp.float32).unet_params
    flat = jconvert.to_torch_layout(jparams)
    keys = sorted(k for k in flat if "attn2.to_" in k)
    rng = np.random.default_rng(1)
    k_w = next(k for k in keys if k.endswith("to_k.weight"))
    v_w = next(k for k in keys if k.endswith("to_v.weight"))
    out_b = next(k for k in keys if k.endswith("to_out.0.bias"))
    full = {"unet." + k_w: torch.from_numpy(rng.standard_normal(flat[k_w].shape,
                                                                np.float32)),
            out_b: torch.from_numpy(rng.standard_normal(flat[out_b].shape, np.float32)),
            "conv_in.weight": torch.zeros(1)}  # not attn2: skipped
    o, i = flat[v_w].shape
    low = {v_w: {"u": torch.from_numpy(rng.standard_normal((o, 2), np.float32)),
                 "v": torch.from_numpy(rng.standard_normal((2, i), np.float32))}}
    t_params = from_jax_params(_np(jparams))
    for state, compress in ((full, False), ({**full, **low}, True)):
        want = jb.apply_custom_diffusion(jparams, state, compress=compress)
        got = tb.apply_custom_diffusion(t_params, state, compress=compress)
        _equal_trees(got, want)
    assert not torch.equal(got_leaf := pytree.flatten(got)[v_w], pytree.flatten(t_params)[v_w])
    assert got_leaf.dtype == torch.float32
    for apply, params in ((jb.apply_custom_diffusion, jparams),
                          (tb.apply_custom_diffusion, t_params)):
        with pytest.raises(KeyError, match="not in UNet"):
            apply(params, {"down_blocks.9.attn2.to_k.weight": torch.zeros(1)})
        with pytest.raises(ValueError, match="no attn2"):
            apply(params, {"conv_in.weight": torch.zeros(1)})


def test_text_encoder_functions_bit_equal(xl):
    """`apply_full_text_encoder` (the resized vocabulary taken whole; a
    missing or unknown key KeyError, another shape ValueError),
    `resize_token_embeddings` (shrink ValueError), `inject_learned_token`
    and `inject_learned_token_xl` in bf16, both packages."""
    jm, tm = _tes(xl, torch.bfloat16)
    j_te, t_te = jm.text_encoders[0].params, tm.text_encoders[0].params
    state = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32) * np.float32(1.5))
             for k, v in jconvert.to_torch_layout(_np(j_te)).items()}
    n, d = state[KEY].shape
    state[KEY] = torch.cat([state[KEY], torch.full((2, d), 0.25)])
    state["text_model.embeddings.position_ids"] = torch.arange(16)[None]
    _equal_trees(tb.apply_full_text_encoder(t_te, state), jb.apply_full_text_encoder(j_te, state),
                 torch.bfloat16)
    assert pytree.flatten(tb.apply_full_text_encoder(t_te, state))[KEY].shape == (n + 2, d)
    bad = [({k: v for k, v in state.items() if "final_layer_norm.bias" not in k}, KeyError,
            "missing"), ({**state, "text_model.extra.weight": torch.zeros(2)}, KeyError,
                         "unknown"),
           ({**state, KEY: torch.zeros(n - 1, d)}, ValueError, "shape")]
    for bad_state, err, msg in bad:
        for apply, te in ((jb.apply_full_text_encoder, j_te), (tb.apply_full_text_encoder, t_te)):
            with pytest.raises(err, match=msg):
                apply(te, bad_state)

    _equal_trees(tb.resize_token_embeddings(t_te, n + 3), jb.resize_token_embeddings(j_te, n + 3),
                 torch.bfloat16)
    for resize, te in ((jb.resize_token_embeddings, j_te), (tb.resize_token_embeddings, t_te)):
        with pytest.raises(ValueError, match="shrink"):
            resize(te, n - 1)
    vecs = np.random.default_rng(3).standard_normal((2, d)).astype(np.float32)
    _equal_trees(tb.inject_learned_token(t_te, torch.from_numpy(vecs), [3, 7]),
                 jb.inject_learned_token(j_te, jnp.asarray(vecs), [3, 7]), torch.bfloat16)
    emb = {"emb": vecs[0], "emb2": vecs[1][:16]}
    toks = [te.tokenizer for te in tm.text_encoders]
    got = tb.inject_learned_token_xl([te.params for te in tm.text_encoders], toks, emb, "old")
    want = jb.inject_learned_token_xl([te.params for te in jm.text_encoders],
                                      [te.tokenizer for te in jm.text_encoders], emb, "old")
    for g, w in zip(got, want):
        _equal_trees(g, w, torch.bfloat16)
    with pytest.raises(ValueError, match="not a single token"):
        tb.inject_learned_token_xl([te.params for te in tm.text_encoders], toks, emb, "old man")


def test_load_custom_diffusion_bit_equal(xl, tmp_path):
    """A checkpoint with both encoders' full state dicts, a modifier token
    with an embedding for each encoder and attn2 deltas (full K, compressed
    V): the reference's load order, both tokenizers grown by one token; a
    second load of the same token raises ValueError in both packages."""
    jm, tm = _tes(xl, torch.float32)
    jflat = jconvert.to_torch_layout(jm.unet_params)
    k_w = next(k for k in sorted(jflat) if "attn2.to_k.weight" in k)
    v_w = next(k for k in sorted(jflat) if "attn2.to_v.weight" in k)
    rng = np.random.default_rng(4)
    o, i = jflat[v_w].shape

    def te_state(bundle, scale):
        return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32) * np.float32(scale))
                for k, v in jconvert.to_torch_layout(_np(bundle.params)).items()}

    ckpt = {"text_encoder": te_state(jm.text_encoders[0], 1.25),
            "text_encoder_2": te_state(jm.text_encoders[1], 0.75),
            "modifier_token": {"<sks>": [torch.full((16,), 0.25), torch.full((16,), -0.5)]},
            "unet": {k_w: torch.from_numpy(rng.standard_normal(jflat[k_w].shape, np.float32)),
                     v_w: {"u": torch.from_numpy(rng.standard_normal((o, 2), np.float32)),
                           "v": torch.from_numpy(rng.standard_normal((2, i), np.float32))}}}
    torch.save(ckpt, tmp_path / "delta.pt")
    j_toks = [te.tokenizer for te in jm.text_encoders]
    t_toks = [te.tokenizer for te in tm.text_encoders]
    n0 = [len(t) for t in t_toks]
    j_unet, j_tes = jb.load_custom_diffusion(str(tmp_path / "delta.pt"), jm.unet_params, j_toks,
                                             [te.params for te in jm.text_encoders],
                                             compress=True)
    t_unet, t_tes = tb.load_custom_diffusion(str(tmp_path / "delta.pt"), tm.unet_params, t_toks,
                                             [te.params for te in tm.text_encoders],
                                             compress=True)
    _equal_trees(t_unet, j_unet)
    for g, w, tok, n in zip(t_tes, j_tes, t_toks, n0):
        _equal_trees(g, w)
        assert len(tok) == n + 1 and tok.convert_tokens_to_ids("<sks>") == n
        assert pytree.flatten(g)[KEY].shape[0] == n + 1
    for load, toks, m in ((jb.load_custom_diffusion, j_toks, jm),
                          (tb.load_custom_diffusion, t_toks, tm)):
        with pytest.raises(ValueError, match="already contains"):
            load(str(tmp_path / "delta.pt"), m.unet_params, toks,
                 [te.params for te in m.text_encoders], compress=True)


@pytest.fixture(scope="module")
def uce(sd_unet):
    rng = np.random.default_rng(7)
    old = sd_unet
    new = jax.tree.map(lambda x: x + np.float32(0.05) * rng.standard_normal(x.shape, np.float32),
                       old)
    cond, uncond = (rng.standard_normal((2, 7, 32)).astype(np.float32) for _ in range(2))
    return old, new, from_jax_params(_np(old)), from_jax_params(_np(new)), cond, uncond


@pytest.mark.parametrize("kind", ["ddim", "lms"])
def test_uce_sampling_matches_jax(uce, kind):
    """start_noise -1 (the boundary past the last step: all base), 500
    (inside) and 1000 (at or above the first timestep: all interpolated), at
    scales -1, 0, 1; scale 0 gives the base model's latents."""
    old, new, t_old, t_new, cond, uncond = uce
    steps = 4
    jfn = jb.make_uce_sampling_fn(junet.TINY, jmake_sampler(jmake_schedule(), kind, steps),
                                  compute_dtype=jnp.float32)
    sampler = make_sampler(make_schedule(), kind, steps)
    tfn = tb.make_uce_sampling_fn(unet2d.TINY, sampler, compute_dtype=torch.float32)
    lats = (np.random.default_rng(8).standard_normal((2, 8, 8, 4))
            * sampler.init_noise_sigma).astype(np.float32)
    base = t2i.make_sampling_fn(unet2d.TINY, sampler, compute_dtype=torch.float32)(
        t_old, torch.from_numpy(lats), torch.from_numpy(cond), torch.from_numpy(uncond), None,
        0.0, -1.0, 7.5)
    outs = {}
    for start_noise in (-1.0, 500.0, 1000.0):
        for scale in (-1.0, 0.0, 1.0):
            ref = np.asarray(jfn(old, new, jnp.asarray(lats), jnp.asarray(cond),
                                 jnp.asarray(uncond), jnp.asarray(scale),
                                 jnp.asarray(start_noise), jnp.asarray(7.5), jax.random.key(0)))
            out = tfn(t_old, t_new, torch.from_numpy(lats), torch.from_numpy(cond),
                      torch.from_numpy(uncond), scale, start_noise, 7.5)
            np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                                       atol=1e-5 * float(np.abs(ref).max()))
            outs[start_noise, scale] = out
    for start_noise in (-1.0, 500.0, 1000.0):
        assert torch.equal(outs[start_noise, 0.0], base)
    assert torch.equal(outs[-1.0, 1.0], base)  # no step at or below -1: all base
    assert not torch.equal(outs[500.0, 1.0], base)
    assert not torch.equal(outs[1000.0, 1.0], outs[500.0, 1.0])
