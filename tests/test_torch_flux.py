"""Parity of the port's FLUX pieces with the JAX package on the CPU, on the
same weights (JAX init carried over by `from_jax_params`) and the same
seeded numpy inputs, in f32: the MMDiT (per-row LoRA multiplier, stacked
adapters), packing, ids and RoPE, the T5 encoder, the FlowMatch tables, the
sampling loop with its skip_till gate, the LoRA targets, and the weight
bridge with T5's embeddings. Tolerances are relative to the output's
largest magnitude: only summation orders differ, compounded through depth.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_tpu.diffusion import schedulers as js
from sliders_tpu.lora import batch as jbatch
from sliders_tpu.lora import network as jnet
from sliders_tpu.models import flux as jflux
from sliders_tpu.models import t5 as jt5
from sliders_tpu.models import vae as jvae
from sliders_tpu.ops.basic import SliderLora as JaxSliderLora
from sliders_tpu.pipelines import flux_t2i as jpipe
from sliders_tpu_torch.diffusion import schedulers as ts
from sliders_tpu_torch.lora import batch as tbatch
from sliders_tpu_torch.lora import network as tnet
from sliders_tpu_torch.models import convert, flux, t5
from sliders_tpu_torch.models import vae as tvae
from sliders_tpu_torch.models.convert import from_jax_params
from sliders_tpu_torch.ops.basic import SliderLora
from sliders_tpu_torch.pipelines import flux_t2i as tpipe
from sliders_tpu_torch.utils import pytree as tpytree

# d = 128 (FLUX's head dim) with 1 head and 1 + 1 blocks, small enough for the CPU
FLUX128 = dataclasses.replace(jflux.TINY, attention_head_dim=128, num_attention_heads=1,
                              num_layers=1, num_single_layers=1, axes_dims_rope=(16, 56, 56))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(out: torch.Tensor, ref, rel: float):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out.detach().float().numpy(), ref, rtol=0, atol=rel * scale)


def _slider(params, seed, method="xattn", rank=4):
    w = jnet.create_slider_network(jax.random.key(seed), params, rank=rank, train_method=method)
    rng = np.random.default_rng(seed)
    return {k: {**v, "up": jnp.asarray(rng.standard_normal(v["up"].shape) * 0.1, jnp.float32)}
            for k, v in w.items()}


def _inputs(cfg, rng, B=3, hw=8, L_txt=5):
    x = rng.standard_normal((B, hw, hw, cfg.in_channels // 4)).astype(np.float32)
    return {
        "packed": np.array(jflux.pack_latents(jnp.asarray(x))),
        "t": np.array([0.9, 0.5, 0.01][:B], np.float32),
        "pooled": rng.standard_normal((B, cfg.pooled_projection_dim)).astype(np.float32),
        "ehs": rng.standard_normal((B, L_txt, cfg.joint_attention_dim)).astype(np.float32),
        "g": np.full((B,), 3.5, np.float32),
        "tids": jflux.text_ids(L_txt),
        "iids": jflux.image_ids(hw, hw),
    }


@pytest.mark.parametrize("guidance_embeds", [True, False])
def test_flux_tiny_apply_per_row_lora_matches_jax(guidance_embeds):
    """FLUX TINY with an xattn slider at per-row scales (1e-4 of the largest
    velocity: f32 through 2 + 2 blocks)."""
    cfg = dataclasses.replace(jflux.TINY, guidance_embeds=guidance_embeds)
    tcfg = dataclasses.replace(flux.TINY, guidance_embeds=guidance_embeds)
    jp = jflux.init_params(jax.random.key(0), cfg)
    sl = _slider(jp, 1)
    d = _inputs(cfg, np.random.default_rng(0))
    mult = np.array([-2.0, 0.0, 1.5], np.float32)
    g = d["g"] if guidance_embeds else None
    ref = jflux.apply(jp, cfg, jnp.asarray(d["packed"]), jnp.asarray(d["t"]),
                      jnp.asarray(d["pooled"]), jnp.asarray(d["ehs"]), jnp.asarray(d["tids"]),
                      jnp.asarray(d["iids"]), guidance=None if g is None else jnp.asarray(g),
                      lora=JaxSliderLora(weights=sl, multiplier=jnp.asarray(mult)))
    out = flux.apply(from_jax_params(_np(jp)), tcfg, torch.from_numpy(d["packed"]),
                     torch.from_numpy(d["t"]), torch.from_numpy(d["pooled"]),
                     torch.from_numpy(d["ehs"]), d["tids"], d["iids"],
                     guidance=None if g is None else torch.from_numpy(g),
                     lora=SliderLora(from_jax_params(_np(sl)), torch.from_numpy(mult)))
    assert out.shape == ref.shape
    _close(out, ref, 1e-4)


def test_flux_stacked_adapters_match_jax():
    """Two different sliders stacked per row (port's stack_sliders against
    the JAX package's), rows at different scales."""
    cfg = jflux.TINY
    jp = jflux.init_params(jax.random.key(0), cfg)
    s1, s2 = _slider(jp, 1), _slider(jp, 2, rank=2)
    rows = [s1, s2, s1]
    jstack = jbatch.stack_sliders(rows, round_ranks_pow2=True)
    tstack = tbatch.stack_sliders([from_jax_params(_np(s)) for s in rows], round_ranks_pow2=True)
    assert tbatch.is_stacked(tstack)
    assert set(tstack) == set(jstack)
    d = _inputs(cfg, np.random.default_rng(1))
    mult = np.array([1.0, -1.0, 2.0], np.float32)
    ref = jflux.apply(jp, cfg, jnp.asarray(d["packed"]), jnp.asarray(d["t"]),
                      jnp.asarray(d["pooled"]), jnp.asarray(d["ehs"]), jnp.asarray(d["tids"]),
                      jnp.asarray(d["iids"]), guidance=jnp.asarray(d["g"]),
                      lora=JaxSliderLora(weights=jstack, multiplier=jnp.asarray(mult)))
    out = flux.apply(from_jax_params(_np(jp)), flux.TINY, torch.from_numpy(d["packed"]),
                     torch.from_numpy(d["t"]), torch.from_numpy(d["pooled"]),
                     torch.from_numpy(d["ehs"]), d["tids"], d["iids"],
                     guidance=torch.from_numpy(d["g"]),
                     lora=SliderLora(tstack, torch.from_numpy(mult)))
    _close(out, ref, 1e-4)
    # row 1's adapter is s2 alone: the same as a solo call with s2
    solo = flux.apply(from_jax_params(_np(jp)), flux.TINY, torch.from_numpy(d["packed"][1:2]),
                      torch.from_numpy(d["t"][1:2]), torch.from_numpy(d["pooled"][1:2]),
                      torch.from_numpy(d["ehs"][1:2]), d["tids"], d["iids"],
                      guidance=torch.from_numpy(d["g"][1:2]),
                      lora=SliderLora(from_jax_params(_np(s2)), torch.tensor([-1.0])))
    torch.testing.assert_close(out[1:2], solo, rtol=0, atol=1e-5)


def test_flux_head_dim_128_matches_jax():
    """FLUX's d = 128 at 16x16 latents (L = 5 + 64 tokens, the plain path)."""
    jp = jflux.init_params(jax.random.key(3), FLUX128)
    d = _inputs(FLUX128, np.random.default_rng(3), B=2, hw=16)
    ref = jflux.apply(jp, FLUX128, *(jnp.asarray(d[k]) for k in
                                     ("packed", "t", "pooled", "ehs", "tids", "iids")),
                      guidance=jnp.asarray(d["g"]))
    out = flux.apply(from_jax_params(_np(jp)), flux.FluxConfig(**dataclasses.asdict(FLUX128)),
                     *(torch.from_numpy(np.asarray(d[k])) for k in
                       ("packed", "t", "pooled", "ehs", "tids", "iids")),
                     guidance=torch.from_numpy(d["g"]))
    _close(out, ref, 1e-4)


def test_pack_unpack_ids_rope_match_jax():
    rng = np.random.default_rng(4)
    lat = rng.standard_normal((2, 8, 6, 16)).astype(np.float32)
    packed = flux.pack_latents(torch.from_numpy(lat))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jflux.pack_latents(jnp.asarray(lat))))
    np.testing.assert_array_equal(flux.unpack_latents(packed, 8, 6).numpy(), lat)
    np.testing.assert_array_equal(flux.image_ids(8, 6), jflux.image_ids(8, 6))
    np.testing.assert_array_equal(flux.text_ids(7), jflux.text_ids(7))
    ids = np.concatenate([jflux.text_ids(3), jflux.image_ids(16, 16)])
    for cfg in (flux.FLUX_DEV, flux.TINY):
        jcfg = jflux.FluxConfig(**dataclasses.asdict(cfg))
        jc, jsn = jflux.rope_tables(jnp.asarray(ids), jcfg)
        tc, tsn = flux.rope_tables(torch.from_numpy(ids), cfg)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tsn.numpy(), np.asarray(jsn), rtol=0, atol=1e-6)
        x = rng.standard_normal((2, ids.shape[0], cfg.inner_dim)).astype(np.float32)
        np.testing.assert_allclose(
            flux.apply_rope(torch.from_numpy(x), tc, tsn, cfg.num_attention_heads).numpy(),
            np.asarray(jflux.apply_rope(jnp.asarray(x), jc, jsn, cfg.num_attention_heads)),
            rtol=0, atol=1e-5)


def test_flux_configs_equal_jax():
    for name in ("FLUX_DEV", "FLUX_SCHNELL", "TINY"):
        assert dataclasses.asdict(getattr(flux, name)) == dataclasses.asdict(getattr(jflux, name))
    for name in ("T5_XXL", "TINY"):
        assert dataclasses.asdict(getattr(t5, name)) == dataclasses.asdict(getattr(jt5, name))
    for name in ("FLUX_VAE", "TINY_FLUX"):
        assert dataclasses.asdict(getattr(tvae, name)) == dataclasses.asdict(getattr(jvae, name))


def test_flux_dev_structure_matches_jax():
    """FLUX-dev and T5-XXL at full size: parameter names and shapes (torch
    layouts) against jax.eval_shape, the port's init on the meta device."""
    for jmod, tmod, cfg in ((jflux, flux, flux.FLUX_DEV), (jt5, t5, t5.T5_XXL)):
        jcfg = type(getattr(jmod, "FLUX_DEV" if jmod is jflux else "T5_XXL"))(
            **dataclasses.asdict(cfg))
        jshapes = jax.eval_shape(lambda: jmod.init_params(jax.random.key(0), jcfg))
        jflat = {p: tuple(v.shape) for p, v in tpytree.flatten(jax.tree.map(
            lambda s: s, jshapes)).items()}
        tflat = tpytree.flatten(tmod.init_params(None, cfg, device="meta"))
        assert set(tflat) == set(jflat)
        for p, shape in jflat.items():
            want = shape[::-1] if len(shape) == 2 and not convert.is_embedding_path(p) else shape
            assert tuple(tflat[p].shape) == want, p
    n = sum(t.numel() for t in tpytree.flatten(
        flux.init_params(None, flux.FLUX_DEV, device="meta")).values())
    assert 11.8e9 < n < 12.0e9


@pytest.mark.parametrize("mask", [False, True])
def test_t5_tiny_matches_jax(mask):
    """T5 TINY (gated tanh GELU, q pre-scaled by sqrt(d_kv), the relative
    position bias), with and without an attention mask."""
    jp = jt5.init_params(jax.random.key(5), jt5.TINY)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, jt5.TINY.vocab_size, size=(2, 12))
    am = np.ones((2, 12), np.int32)
    am[1, 7:] = 0
    ref = jt5.apply(jp, jnp.asarray(ids), jt5.TINY,
                    attention_mask=jnp.asarray(am) if mask else None)
    out = t5.apply(from_jax_params(_np(jp)), torch.from_numpy(ids), t5.TINY,
                   attention_mask=torch.from_numpy(am) if mask else None)
    _close(out, ref, 1e-5)
    bias = t5.position_bias(from_jax_params(_np(jp)), t5.TINY, 40)
    np.testing.assert_allclose(bias.numpy(), np.asarray(jt5.position_bias(jp, jt5.TINY, 40)),
                               rtol=0, atol=0)


def test_t5_bf16_rounds_like_jax():
    """In bf16 the q scale by sqrt(d_kv) is taken in the activation dtype, as
    in the JAX package: the outputs agree to a few bf16 ulps."""
    jp = jt5.init_params(jax.random.key(6), jt5.TINY)
    ids = np.random.default_rng(6).integers(0, 100, size=(1, 9))
    ref = jt5.apply(jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp), jnp.asarray(ids),
                    jt5.TINY)
    tp = {k: v for k, v in from_jax_params(_np(jp)).items()}
    from sliders_tpu_torch.models.params import tree_to

    out = t5.apply(tree_to(tp, dtype=torch.bfloat16), torch.from_numpy(ids), t5.TINY)
    assert out.dtype == torch.bfloat16
    _close(out, np.asarray(ref.astype(jnp.float32)), 2**-5)


@pytest.mark.parametrize("steps,seq", [(30, 4096), (4, 1024), (2, 4096), (28, 256)])
def test_flowmatch_tables_match_jax(steps, seq):
    j = js.make_flowmatch_sampler(steps, image_seq_len=seq)
    t = ts.make_flowmatch_sampler(steps, image_seq_len=seq)
    np.testing.assert_array_equal(t.timesteps.numpy(), np.asarray(j.timesteps))
    np.testing.assert_array_equal(t.sigmas.numpy(), np.asarray(j.sigmas))
    assert ts.calculate_shift(seq) == js.calculate_shift(seq)
    rng = np.random.default_rng(steps)
    x, v = (rng.standard_normal((2, 4, 8)).astype(np.float32) for _ in range(2))
    for i in (0, steps - 1):
        np.testing.assert_allclose(
            t.step(i, torch.from_numpy(v), torch.from_numpy(x)).numpy(),
            np.asarray(j.step(i, jnp.asarray(v), jnp.asarray(x))), rtol=0, atol=1e-6)
    # bf16: dt is cast to the latents' dtype, as `_bcast` does
    xb = torch.from_numpy(x).bfloat16()
    ref = j.step(1, jnp.asarray(v).astype(jnp.bfloat16), jnp.asarray(x).astype(jnp.bfloat16))
    out = t.step(1, torch.from_numpy(v).bfloat16(), xb)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_flux_sampling_fn_and_skip_till_gate_match_jax():
    """Three FlowMatch steps of FLUX TINY with injected numpy noise, an xattn
    slider at per-row scales and per-row skip_till: -1 (always on), 1 (on
    from step 2) and 5 (past the last step, so the row must equal the
    scale-0 row)."""
    cfg = jflux.TINY
    jp = jflux.init_params(jax.random.key(7), cfg)
    sl = _slider(jp, 8)
    rng = np.random.default_rng(7)
    B, hw = 4, 8
    noise = rng.standard_normal((1, hw, hw, 4)).astype(np.float32)
    lat = np.repeat(np.asarray(jflux.pack_latents(jnp.asarray(noise))), B, axis=0)
    pooled = np.repeat(rng.standard_normal((1, 24)).astype(np.float32), B, axis=0)
    t5e = np.repeat(rng.standard_normal((1, 6, 32)).astype(np.float32), B, axis=0)
    scale = np.array([1.5, 1.5, 2.0, 0.0], np.float32)
    skip = np.array([-1.0, 1.0, 5.0, -1.0], np.float32)
    g = np.full((B,), 3.5, np.float32)
    n = 3
    jfn = jpipe.make_flux_sampling_fn(cfg, js.make_flowmatch_sampler(n, image_seq_len=16),
                                      latent_hw=hw, compute_dtype=jnp.float32)
    ref = np.asarray(jfn(jp, jnp.asarray(lat), jnp.asarray(pooled), jnp.asarray(t5e), sl,
                         jnp.asarray(scale), jnp.asarray(skip), jnp.asarray(g)))
    tfn = tpipe.make_flux_sampling_fn(flux.TINY, ts.make_flowmatch_sampler(n, image_seq_len=16),
                                      latent_hw=hw, compute_dtype=torch.float32)
    out = tfn(from_jax_params(_np(jp)), torch.from_numpy(lat), torch.from_numpy(pooled),
              torch.from_numpy(t5e), from_jax_params(_np(sl)), torch.from_numpy(scale),
              torch.from_numpy(skip), torch.from_numpy(g))
    _close(out, ref, 1e-4)
    torch.testing.assert_close(out[2], out[3], rtol=0, atol=0)  # gate never opened
    assert not torch.equal(out[0], out[1])  # the gate opened at another step
    # a scalar scale takes the merged-delta path: every row is row 0's
    # (scale 1.5, skip_till -1) up to the rounding of W + delta (f32)
    merged = tfn(from_jax_params(_np(jp)), torch.from_numpy(lat), torch.from_numpy(pooled),
                 torch.from_numpy(t5e), from_jax_params(_np(sl)), 1.5, -1.0, 3.5)
    for b in range(B):
        _close(merged[b:b + 1], out[:1].numpy(), 1e-5)
    with pytest.raises(NotImplementedError, match="item 15"):
        tpipe.make_flux_sampling_fn(flux.TINY, ts.make_flowmatch_sampler(2, 16), latent_hw=hw,
                                    mesh=object())


@pytest.mark.parametrize("method", ["full", "xattn", "xattn-strict", "noxattn", "selfattn",
                                    "innoxattn", "xattn-up"])
def test_flux_lora_targets_match_jax(method):
    jp = jflux.init_params(jax.random.key(0), jflux.TINY)
    tp = from_jax_params(_np(jp))
    try:
        want = jnet.target_module_paths(jp, "lierla", method)
    except NotImplementedError:
        pytest.fail(method)
    assert tnet.target_module_paths(tp, "lierla", method) == want
    if want:
        w = tnet.create_slider_network(torch.Generator().manual_seed(0), tp, rank=4,
                                       train_method=method)
        jw = jnet.create_slider_network(jax.random.key(0), jp, rank=4, train_method=method)
        assert set(w) == set(jw)
        for m, e in w.items():
            assert e["down"].shape == jw[m]["down"].shape[::-1]
            assert e["up"].shape == jw[m]["up"].shape[::-1]


def test_stacking_is_name_generic_over_flux_modules():
    """lora/batch.py over FLUX module names: signatures, rank padding and
    the per-row true ranks, equal to the JAX package's."""
    jp = jflux.init_params(jax.random.key(0), jflux.TINY)
    a, b = _slider(jp, 1, rank=4), _slider(jp, 2, rank=3)
    ta, tb = from_jax_params(_np(a)), from_jax_params(_np(b))
    assert tbatch.structure_signature(ta) == tbatch.structure_signature(tb)
    assert all(n.startswith(("transformer_blocks.", "single_transformer_blocks."))
               for n in ta)
    out = tbatch.stack_sliders([ta, tb, ta], round_ranks_pow2=True)
    ref = jbatch.stack_sliders([a, b, a], round_ranks_pow2=True)
    for name, e in out.items():
        np.testing.assert_array_equal(e["rank"].numpy(), np.asarray(ref[name]["rank"]))
        np.testing.assert_allclose(e["down"].numpy(),
                                   np.asarray(ref[name]["down"]).transpose(0, 2, 1), atol=0)
        np.testing.assert_allclose(e["up"].numpy(),
                                   np.asarray(ref[name]["up"]).transpose(0, 2, 1), atol=0)


def test_from_jax_params_keeps_t5_embeddings():
    """The T5 token embedding, its tied copy and the relative position table
    are (rows, cols) in both layouts: a transpose would turn the (vocab,
    d_model) embedding into (d_model, vocab) and index the wrong rows."""
    jp = jt5.init_params(jax.random.key(9), jt5.TINY)
    jp["encoder"]["embed_tokens"] = {"weight": jp["shared"]["weight"]}
    tp = from_jax_params(_np(jp))
    for path in ("shared.weight", "encoder.embed_tokens.weight",
                 "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"):
        assert convert.is_embedding_path(path)
    np.testing.assert_array_equal(tp["shared"]["weight"].numpy(), np.asarray(jp["shared"]["weight"]))
    np.testing.assert_array_equal(tp["encoder"]["embed_tokens"]["weight"].numpy(),
                                  np.asarray(jp["shared"]["weight"]))
    rel = tp["encoder"]["block"]["0"]["layer"]["0"]["SelfAttention"]["relative_attention_bias"]
    assert tuple(rel["weight"].shape) == (32, jt5.TINY.num_heads)
    q = tp["encoder"]["block"]["0"]["layer"]["0"]["SelfAttention"]["q"]["weight"]
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(jp["encoder"]["block"]["0"]["layer"]["0"]["SelfAttention"]["q"]
                              ["weight"]).T)


def test_flux_tree_from_jax_params_equals_snapshot_load(tmp_path):
    """A FLUX tree through `from_jax_params` equals the same tree written as
    a diffusers component (the JAX package's own exporter, torch layout) and
    read back by the port, split over two shards with no index file."""
    from sliders_tpu.models import convert as jconvert
    from sliders_tpu_torch.models.convert import load_component, write_safetensors

    jp = jflux.init_params(jax.random.key(11), jflux.TINY)
    state = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
             for k, v in jconvert.to_torch_layout(jp).items()}
    names = sorted(state)
    comp = tmp_path / "transformer"
    comp.mkdir()
    half = len(names) // 2
    for i, part in enumerate((names[:half], names[half:])):
        write_safetensors(str(comp / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"),
                          {k: state[k] for k in part})
    loaded = tpytree.flatten(load_component(str(tmp_path), "transformer"))
    bridged = tpytree.flatten(from_jax_params(_np(jp)))
    assert set(loaded) == set(bridged) == set(names)
    for k in names:
        torch.testing.assert_close(loaded[k], bridged[k], rtol=0, atol=0)
    assert os.path.exists(comp / "diffusion_pytorch_model-00002-of-00002.safetensors")
