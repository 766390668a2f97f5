"""Attention control in the port against sliders_tpu on the CPU: the
`ops/attention.AttentionTap` store of one TINY UNet forward (the same
call-site keys in the same order, the probabilities (B, H, Lq, Lkv) and the
noise prediction within 1e-5 of the largest value, f32), the reference
AttentionStore grouping, `aggregate_attention` and `word_attention_maps`;
a filtered tap that leaves every call it does not want on its kernel route
(at 32 x 32 latents TINY's level-0 self-attentions, L = 1024, take #1,
whose plain version runs here), and no tap outside its context.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers import make_tokenizer_files

from sliders_tpu.models import unet2d as junet
from sliders_tpu.pipelines import attention_control as jac
from sliders_tpu.text.tokenizer import ClipTokenizer as JTokenizer
from sliders_tpu_torch.models import unet2d as tunet
from sliders_tpu_torch.models.convert import from_jax_params
from sliders_tpu_torch.ops import attention as tattn
from sliders_tpu_torch.pipelines import attention_control as tac
from sliders_tpu_torch.text.tokenizer import ClipTokenizer

REL = 1e-5


def _close(out, ref, rel=REL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(torch.as_tensor(out).float()), ref, rtol=0,
                               atol=rel * float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def maps():
    params = junet.init_params(jax.random.key(0), junet.TINY)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ehs = rng.standard_normal((2, 7, 32)).astype(np.float32)
    t = np.array([1.0, 501.0], np.float32)
    jeps, jraw = jac.make_attention_maps_fn(junet.TINY)(params, x, jnp.asarray(t), ehs)
    tparams = from_jax_params(jax.tree.map(np.asarray, params))
    teps, traw = tac.make_attention_maps_fn(tunet.TINY)(tparams, torch.tensor(x),
                                                        torch.tensor(t), torch.tensor(ehs))
    return dict(jeps=np.asarray(jeps), jraw={k: np.asarray(v) for k, v in jraw.items()},
                teps=teps, traw=traw, tparams=tparams, x=x, ehs=ehs, t=t)


def test_tap_store_matches_jax(maps):
    """Every attention call site of TINY (4 self, 4 cross) keyed by its
    path, in call order, its probabilities within 1e-5 (rows sum to 1)."""
    assert list(maps["traw"]) == list(maps["jraw"])
    assert len(maps["traw"]) == 8
    _close(maps["teps"], maps["jeps"])
    for k, ref in maps["jraw"].items():
        probs = maps["traw"][k]
        assert probs.shape == ref.shape and probs.dtype == torch.float32
        _close(probs, ref)
        torch.testing.assert_close(probs.sum(-1), torch.ones(probs.shape[:-1]), rtol=0,
                                   atol=1e-5)


def test_grouping_and_aggregation_match_jax(maps):
    """The AttentionStore lists, the 16 x 16 cross maps over up and down and
    the 8 x 8 self maps of the mid block, against the JAX package's."""
    tstore, jstore = tac.group_store(maps["traw"]), jac.group_store(maps["jraw"])
    assert {k: len(v) for k, v in tstore.items()} == {k: len(v) for k, v in jstore.items()}
    assert len(tstore["up_cross"]) == 2 and len(tstore["mid_self"]) == 1
    for args in ((16, ("up", "down"), True, 0), (16, ("up", "down"), True, 1),
                 (8, ("mid",), False, 0)):
        agg = tac.aggregate_attention(tstore, *args)
        ref = jac.aggregate_attention(jstore, *args)
        assert agg.shape == ref.shape and agg.dtype == np.float32
        _close(torch.from_numpy(agg), ref)
    with pytest.raises(ValueError, match="no attention maps"):
        tac.aggregate_attention(tstore, 5)
    assert tac.place_in_unet("mid_block.attentions.0.transformer_blocks.0.attn1") == "mid"
    with pytest.raises(ValueError):
        tac.place_in_unet("text_model.encoder.layers.0.self_attn")


def test_word_attention_maps_match_jax(maps, tmp_path):
    """Per-token (pos:token) maps, min-max normalised, with the JAX
    package's keys and values."""
    make_tokenizer_files(str(tmp_path))
    ttok, jtok = ClipTokenizer.from_pretrained(str(tmp_path)), JTokenizer.from_pretrained(
        str(tmp_path))
    store = tac.group_store(maps["traw"])
    agg = tac.aggregate_attention(store, 16)
    out = tac.word_attention_maps(ttok, "old person", agg)
    ref = jac.word_attention_maps(jtok, "old person", agg)
    assert list(out) == list(ref) and list(out)[0].startswith("0:<|startoftext|>")
    for k in out:
        assert out[k].shape == (16, 16) and 0.0 <= out[k].min() and out[k].max() <= 1.0
        np.testing.assert_array_equal(out[k], ref[k])


def test_filtered_tap_leaves_other_calls_on_their_route(maps, monkeypatch):
    """At 32 x 32 latents the 3 level-0 self-attentions (L = 1024) route to
    #1. A tap that wants only attn2 stores the 4 cross-attentions and leaves
    those 3 on #1's route; an unfiltered tap takes every call off it. The
    noise prediction is the same bits in all three runs (the tap's plain
    path is #1's plain version)."""
    calls = []
    route = tattn.sd_attention

    def counted(q, k, v):
        calls.append(q.shape)
        return route(q, k, v)

    monkeypatch.setattr(tattn, "sd_attention", counted)
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal((1, 32, 32, 4)).astype(np.float32))
    ehs = torch.tensor(rng.standard_normal((1, 7, 32)).astype(np.float32))
    t = torch.tensor([301.0])
    with torch.inference_mode():
        eps = tunet.apply(maps["tparams"], tunet.TINY, x, t, ehs)
    assert len(calls) == 3 and all(s[2] == 1024 for s in calls)
    calls.clear()
    eps2, raw2 = tac.make_attention_maps_fn(tunet.TINY, attn_filter=lambda n: n.endswith("attn2"))(
        maps["tparams"], x, t, ehs)
    assert len(calls) == 3
    assert len(raw2) == 4 and all(k.endswith("attn2") for k in raw2)
    calls.clear()
    eps_all, raw_all = tac.make_attention_maps_fn(tunet.TINY)(maps["tparams"], x, t, ehs)
    assert calls == [] and len(raw_all) == 8
    assert torch.equal(eps2, eps) and torch.equal(eps_all, eps)


def test_tap_does_not_leak_outside_its_context():
    """Only named calls are tapped; leaving a tap restores the one before
    (None at the top), and an untapped call stores nothing."""
    q = torch.randn(1, 8, 16)
    with tattn.AttentionTap() as outer:
        tattn.multihead_attention(q, q, q, 2, name="x.attn1")
        tattn.multihead_attention(q, q, q, 2)  # unnamed: never tapped
        with tattn.AttentionTap(filter_fn=lambda n: n == "y.attn2") as inner:
            tattn.multihead_attention(q, q, q, 2, name="x.attn1")
            tattn.multihead_attention(q, q, q, 2, name="y.attn2")
        assert tattn._active_tap is outer
        tattn.multihead_attention(q, q, q, 2, name="z.attn1")
    assert list(outer.store) == ["x.attn1", "z.attn1"] and list(inner.store) == ["y.attn2"]
    assert tattn._active_tap is None
    out = tattn.multihead_attention(q, q, q, 2, name="x.attn1")
    assert out.shape == q.shape and list(outer.store) == ["x.attn1", "z.attn1"]
    assert torch.equal(out, tattn.multihead_attention(q, q, q, 2))
