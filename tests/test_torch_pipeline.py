"""The port's FLUX pipeline (`sliders_tpu_torch/parallel/pipeline.py`) on 2
and 4 gloo CPU ranks (`tests/torch_mesh_helpers.run_ranks`) against
sliders_tpu on the conftest's 8 virtual CPU devices:

- `flux_apply_pp` (every rank calling it with the same inputs, 2
  microbatches) against JAX's `flux_apply_pp` on a pp = 4 mesh and against
  the port's unsharded `flux.apply`: with no slider on JAX's test config
  (4 + 4 blocks), with a scalar-scaled slider at identity-padding shapes
  (3 double / 5 single blocks: at pp = 4 the last stage holds none, where
  JAX pads a zero block), and with per-row multipliers and per-row stacked
  adapters (against JAX's unsharded `flux.apply`, since JAX's pipeline
  refuses them: pinned below);
- the non-uniform-LoRA and indivisible-batch ValueErrors, word for word;
- each rank holding only its stage's blocks, drawn in the world-1 order.

Tolerance against JAX: 1e-4 of the largest velocity, as
`tests/test_torch_flux.py` holds the unsharded port to JAX (f32, only
summation orders differ); against the port's unsharded apply: 1e-6 of it
(the same ops on a microbatch's rows).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_mesh_helpers import flux_pp_rank, run_ranks

from sliders_tpu.lora import batch as jbatch
from sliders_tpu.lora import network as jnet
from sliders_tpu.models import flux as jflux
from sliders_tpu.ops.basic import SliderLora as JaxSliderLora
from sliders_tpu.parallel import mesh as jmesh
from sliders_tpu.parallel import pipeline as jpl
from sliders_tpu_torch.lora import batch as tbatch
from sliders_tpu_torch.models import flux
from sliders_tpu_torch.models.convert import from_jax_params
from sliders_tpu_torch.ops.basic import SliderLora

# the JAX package's tests/test_pipeline.py config, and the padding shapes
CFG = dataclasses.replace(jflux.TINY, num_layers=4, num_single_layers=4)
PAD = dataclasses.replace(jflux.TINY, num_layers=3, num_single_layers=5)
B = 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_cfg(cfg):
    return dataclasses.replace(flux.TINY, num_layers=cfg.num_layers,
                               num_single_layers=cfg.num_single_layers)


def _inputs(cfg, seed, batch=B, hw=8, L_txt=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, hw, hw, cfg.in_channels // 4)).astype(np.float32)
    return {"packed": np.array(jflux.pack_latents(jnp.asarray(x))),
            "t": np.linspace(0.2, 0.9, batch).astype(np.float32),
            "pooled": rng.standard_normal((batch, cfg.pooled_projection_dim)).astype(np.float32),
            "ehs": rng.standard_normal((batch, L_txt, cfg.joint_attention_dim)).astype(
                np.float32),
            "g": np.full((batch,), 1.5, np.float32),
            "tids": jflux.text_ids(L_txt), "iids": jflux.image_ids(hw, hw)}


def _slider(params, seed, rank=4):
    w = jnet.create_slider_network(jax.random.key(seed), params, rank=rank, train_method="xattn")
    rng = np.random.default_rng(seed)
    return {k: {**v, "up": jnp.asarray(rng.standard_normal(v["up"].shape) * 0.1, jnp.float32)}
            for k, v in w.items()}


def _jax(fn, d, **kw):
    """`fn` on the inputs `d`, jitted (the JAX tests' way to run the pipeline)."""
    args = [jnp.asarray(d[k]) for k in ("packed", "t", "pooled", "ehs", "g")]
    tids, iids = jnp.asarray(d["tids"]), jnp.asarray(d["iids"])
    return np.asarray(jax.jit(lambda x, t, pooled, ehs, g: fn(
        x, t, pooled, ehs, tids, iids, guidance=g, **kw))(*args))


def _torch_inputs(d):
    return {k: (torch.from_numpy(np.ascontiguousarray(v)) if k not in ("tids", "iids") else v)
            for k, v in d.items()}


def _close(out, ref, rel):
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=rel * scale)


@pytest.fixture(scope="module")
def cases():
    """The cases every rank runs, and their references: (port case,
    JAX reference or None, expected error or None)."""
    jm = jmesh.make_mesh(dp=1, tp=1, pp=4)
    out = []
    # 1: no slider, JAX's config, 2 microbatches
    p = jflux.init_params(jax.random.key(0), CFG)
    d = _inputs(CFG, 0)
    ref = _jax(lambda *a, **kw: jpl.flux_apply_pp(p, CFG, *a, jm, num_microbatches=2, **kw), d)
    out.append(({"cfg": _port_cfg(CFG), "params": from_jax_params(_np(p)),
                 "inputs": _torch_inputs(d), "lora": None, "multiplier": None,
                 "microbatches": 2}, ref, None))
    # 2: a scalar-scaled slider at padding shapes (JAX pads with zero blocks)
    pp = jflux.init_params(jax.random.key(1), PAD)
    s = _slider(pp, 2)
    d = _inputs(PAD, 1)
    lora = JaxSliderLora(weights=s, multiplier=jnp.asarray(1.5, jnp.float32))
    ref = _jax(lambda *a, **kw: jpl.flux_apply_pp(pp, PAD, *a, jm, lora=lora,
                                                  num_microbatches=2, **kw), d)
    tpad = from_jax_params(_np(pp))
    out.append(({"cfg": _port_cfg(PAD), "params": tpad, "inputs": _torch_inputs(d),
                 "lora": from_jax_params(_np(s)), "multiplier": torch.tensor(1.5),
                 "microbatches": 2}, ref, None))
    # 3: per-row multipliers and per-row stacked adapters (two sliders)
    s1, s2 = _slider(pp, 3), _slider(pp, 4, rank=2)
    rows = [s1, s2, s2, s1]
    mult = np.array([-2.0, 1.0, 0.5, 2.0], np.float32)
    ref = _jax(lambda *a, **kw: jflux.apply(pp, PAD, *a, **kw), d,
               lora=JaxSliderLora(weights=jbatch.stack_sliders(rows, round_ranks_pow2=True),
                                  multiplier=jnp.asarray(mult)))
    stacked = tbatch.stack_sliders([from_jax_params(_np(w)) for w in rows],
                                   round_ranks_pow2=True)
    out.append(({"cfg": _port_cfg(PAD), "params": tpad, "inputs": _torch_inputs(d),
                 "lora": stacked, "multiplier": torch.from_numpy(mult), "microbatches": 2},
                ref, None))
    # 4: non-uniform targeting (one layer's to_q dropped): JAX's message
    holed = {k: v for k, v in s.items() if k != "transformer_blocks.1.attn.to_q"}
    with pytest.raises(ValueError) as err:
        jpl.stack_layer_lora(holed, "transformer_blocks", PAD.num_layers)
    out.append(({**out[1][0], "lora": from_jax_params(_np(holed))}, None, str(err.value)))
    # 5: a batch that the microbatches do not divide: JAX's message
    with pytest.raises(ValueError) as err:
        jpl.split_microbatches({"x": jnp.zeros((B, 2))}, 3)
    out.append(({**out[0][0], "microbatches": 3}, None, str(err.value)))
    # 6: the weights drawn on each rank in the world-1 order, stage kept
    out.append(({"cfg": _port_cfg(PAD), "seed": 7, "inputs": _torch_inputs(d), "lora": None,
                 "multiplier": None, "microbatches": 1}, None, None))
    return out


def _unsharded(case):
    cfg, d = case["cfg"], case["inputs"]
    params = case.get("params")
    if params is None:
        params = flux.init_params(torch.Generator().manual_seed(case["seed"]), cfg)
    lora = None if case["lora"] is None else SliderLora(case["lora"], case["multiplier"])
    return flux.apply(params, cfg, d["packed"], d["t"], d["pooled"], d["ehs"], d["tids"],
                      d["iids"], guidance=d["g"], lora=lora)


@pytest.mark.parametrize("world", [2, 4])
def test_flux_apply_pp_matches_jax_and_unsharded(cases, tmp_path, world):
    out = tmp_path / "pp"
    run_ranks(flux_pp_rank, world, [c for c, _, _ in cases], str(out), tag=f"pp={world}")
    ranks = [torch.load(f"{out}.{r}") for r in range(world)]
    for i, (case, ref, error) in enumerate(cases):
        v = ranks[0][i][0]
        if error is not None:
            assert v == error, (i, v)
            continue
        assert all(ranks[r][i][0] for r in range(1, world))  # None past stage 0
        if ref is not None:
            _close(v, ref, 1e-4)
        _close(v, _unsharded(case).numpy(), 1e-6)
    # each rank holds its stage's blocks only: ceil(n / pp) a stage
    n_d, n_s = PAD.num_layers, PAD.num_single_layers
    for r in range(world):
        blocks = ranks[r][5][1]
        sd, ss = -(-n_d // world), -(-n_s // world)
        assert blocks["transformer_blocks"] == list(range(min(n_d, r * sd),
                                                          min(n_d, (r + 1) * sd)))
        assert blocks["single_transformer_blocks"] == list(range(min(n_s, r * ss),
                                                                 min(n_s, (r + 1) * ss)))
    if world == 4:  # the padding shapes: the last stage holds no block of either stack
        assert ranks[3][5][1] == {"transformer_blocks": [], "single_transformer_blocks": []}


def test_jax_pipeline_refuses_per_row_multipliers():
    """The JAX fault the port does not follow (ROADMAP queue 3): JAX's
    pipeline raises for a (B,) slider scale, which its FLUX engine always
    passes; the port's runs per-row scales (above)."""
    jm = jmesh.make_mesh(dp=1, tp=1, pp=2)
    p = jflux.init_params(jax.random.key(0), PAD)
    s = _slider(p, 2)
    d = _inputs(PAD, 1, batch=2)
    with pytest.raises(ValueError, match="pipeline LoRA multiplier must be a scalar"):
        _jax(lambda *a, **kw: jpl.flux_apply_pp(
            p, PAD, *a, jm, lora=JaxSliderLora(weights=s, multiplier=jnp.asarray([1.0, -1.0])),
            **kw), d)
