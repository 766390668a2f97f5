"""The port's process mesh and tensor-parallel split (`parallel/mesh.py`,
`parallel/collectives.py`, the UNet's tp blocks) against sliders_tpu on
the CPU.

- `make_mesh`'s shapes and errors against JAX `make_mesh` on the conftest's
  8 virtual CPU devices (the port's mesh over 8 ranks, as arithmetic);
- `param_spec` against JAX `param_spec` for every path of the TINY, SD1.5,
  SD2.1 and SDXL UNet trees (the structure only, no weights), and the
  GEGLU and head-count traps of `shard_params`;
- the collectives in 2 gloo ranks;
- the tp = 2 TINY UNet forward and its LoRA gradients (remat on) against
  the JAX package's single-device `unet2d.apply`, within atol 1e-4, the
  tolerance of JAX's own tp test (tests/test_parallel.py).

The multi-process cases run through `tests/torch_mesh_helpers.run_ranks`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_mesh_helpers import collectives_rank, run_ranks, unet_tp_rank

from sliders_tpu.lora import network as jnet
from sliders_tpu.models import unet2d as junet
from sliders_tpu.ops.basic import SliderLora as JLora
from sliders_tpu.parallel import mesh as jmesh
from sliders_tpu.utils import pytree as jtree
from sliders_tpu_torch.models import unet2d as tunet
from sliders_tpu_torch.models.convert import from_jax_params
from sliders_tpu_torch.parallel import collectives as pc
from sliders_tpu_torch.parallel import mesh as pm
from sliders_tpu_torch.utils import pytree

MESHES = [(-1, 1, 1, 1), (-1, 2, 1, 1), (2, 2, 1, 1), (4, 2, 1, 1), (1, 8, 1, 1), (2, 1, 2, 2),
          (-1, 2, 2, 1), (3, 1, 1, 1), (-1, 1, 1, 4)]
BAD = [(-1, 3, 1, 1), (4, 4, 1, 1), (3, 3, 1, 1), (-1, 1, 3, 1), (2, 2, 2, 2)]


@pytest.mark.parametrize("dp,tp,sp,pp", MESHES)
def test_make_mesh_shapes_match_jax(dp, tp, sp, pp):
    jm = jmesh.make_mesh(dp=dp, tp=tp, sp=sp, pp=pp)
    assert len(jax.devices()) == 8
    tm = pm.make_mesh(dp=dp, tp=tp, sp=sp, pp=pp, world=8)
    assert tuple(tm.shape) == jm.axis_names
    assert tm.shape == dict(jm.shape)
    # a single process is rank 0: the first device of every axis
    assert tm.coords == {a: 0 for a in jm.axis_names} and tm.active and tm.is_main
    assert tm.groups == {} and tm.backend == "none"


@pytest.mark.parametrize("dp,tp,sp,pp", BAD)
def test_make_mesh_errors_match_jax(dp, tp, sp, pp):
    with pytest.raises(ValueError) as jerr:
        jmesh.make_mesh(dp=dp, tp=tp, sp=sp, pp=pp)
    with pytest.raises(ValueError) as terr:
        pm.make_mesh(dp=dp, tp=tp, sp=sp, pp=pp, world=8)
    assert str(terr.value) == str(jerr.value)


def test_single_process_mesh_needs_no_process_group():
    """World 1 (no process group): tp = 2 raises the JAX message, a 1 x 1
    mesh runs every collective as the identity."""
    with pytest.raises(ValueError, match="1 devices not divisible by tp"):
        pm.make_mesh(dp=-1, tp=2)
    with pytest.raises(ValueError, match=r"mesh 2x2x1x1 needs 4 devices, have 1"):
        pm.make_mesh(dp=2, tp=2)
    m = pm.make_mesh()
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(pc.gather_rows(pc.scatter_rows(x, m), 3, m), x)
    assert torch.equal(pc.reduce_from_tp(pc.copy_to_tp(x, m), m), x)
    m.tp_split = {"a"}
    assert torch.equal(pc.all_reduce_grads({"a": {"down": x}}, m)["a"]["down"], x)
    assert pm.shard_params(m, {"w": x}, tp_enabled=True) == {"w": x}


@pytest.mark.parametrize("name", ["TINY", "TINY_XL", "SD15", "SD21", "SDXL"])
def test_param_spec_matches_jax_on_every_path(name):
    """Every parameter path of the UNet tree, with the leaf's rank (JAX
    drops a spec longer than it): the port's spec equals JAX's, under tp
    and without."""
    jshapes = jax.eval_shape(lambda: junet.init_params(jax.random.key(0), getattr(junet, name)))
    jflat = jtree.flatten(jshapes)
    tflat = pytree.flatten(tunet.init_params(None, getattr(tunet, name), device="meta"))
    assert set(jflat) == set(tflat)
    n_split = 0
    for path, leaf in jflat.items():
        for enabled in (True, False):
            jspec = jmesh.param_spec(path, enabled)
            if len(jspec) > leaf.ndim:
                jspec = ()
            tspec = pm.param_spec(path, enabled, tflat[path].ndim)
            assert tuple(jspec) == tspec, path
        n_split += bool(pm.param_spec(path, True, leaf.ndim))
    assert n_split > 0


def test_param_spec_flux_rules_and_rank_check():
    base = "transformer_blocks.3.attn"
    for path in (f"{base}.add_q_proj.weight", f"{base}.to_add_out.weight",
                 "transformer_blocks.0.ff_context.net.0.proj.bias",
                 "single_transformer_blocks.17.proj_mlp.weight",
                 "single_transformer_blocks.17.proj_out.weight", "proj_out.weight",
                 "x.attn1.to_q.bias"):
        assert pm.param_spec(path, True) == tuple(jmesh.param_spec(path, True))
    assert pm.param_spec("a.ff.net.0.proj.bias", True, ndim=0) == ()


def test_shard_params_geglu_and_head_traps():
    """GEGLU's [h | gate] output: rank r keeps the r-th slice of each half.
    SD2.1's 5-head level at tp = 2 stays whole (and its LoRA unsplit)."""
    m = pm.make_mesh(world=2, tp=2)
    w = torch.arange(8.0)[:, None].expand(8, 3).contiguous()  # (out = 2 * 4, in)
    params = {"b": {"ff": {"net": {"0": {"proj": {"weight": w, "bias": torch.arange(8.0)}},
                                   "2": {"weight": torch.ones(3, 4)}}}}}
    out = pm.shard_params(m, params, tp_enabled=True, geglu={"b.ff"})
    proj = out["b"]["ff"]["net"]["0"]["proj"]
    assert proj["bias"].tolist() == [0.0, 1.0, 4.0, 5.0]  # rank 0: h[0:2] and gate[0:2]
    assert torch.equal(proj["weight"][:, 0], torch.tensor([0.0, 1.0, 4.0, 5.0]))
    assert out["b"]["ff"]["net"]["2"]["weight"].shape == (3, 2)
    assert m.tp_split == {"b.ff.net.0.proj", "b.ff.net.2"}

    shapes = pytree.flatten(tunet.init_params(None, tunet.SD21, device="meta"))
    m21 = pm.make_mesh(world=2, tp=2)
    sharded = pytree.flatten(pm.shard_params(m21, pytree.unflatten(shapes), tp_enabled=True,
                                             heads=tunet.attention_heads(tunet.SD21),
                                             geglu=tunet.geglu_units(tunet.SD21)))
    level0 = "down_blocks.0.attentions.0.transformer_blocks.0"
    assert sharded[f"{level0}.attn1.to_q.weight"].shape == (320, 320)  # 5 heads: whole
    assert f"{level0}.attn1.to_q" not in m21.tp_split
    assert sharded[f"{level0}.ff.net.2.weight"].shape == (320, 640)  # the ff still splits
    level1 = "down_blocks.1.attentions.0.transformer_blocks.0"
    assert sharded[f"{level1}.attn2.to_k.weight"].shape == (320, 1024)  # 10 heads: split
    assert sharded[f"{level1}.attn2.to_out.0.weight"].shape == (640, 320)
    assert {f"{level1}.attn2.to_k", f"{level1}.attn2.to_out.0"} <= m21.tp_split
    assert tunet.attention_heads(tunet.SDXL)["mid_block.attentions.0.transformer_blocks.9.attn2"] \
        == 20


def test_row_range_and_shard_slice():
    assert [pc.row_range(3, 2, r) for r in range(2)] == [(0, 2), (2, 3)]
    assert [pc.row_range(1, 2, r) for r in range(2)] == [(0, 1), (1, 1)]
    assert [pc.row_range(4, 2, r) for r in range(2)] == [(0, 2), (2, 4)]
    t = torch.arange(12).reshape(2, 6)
    assert pc.shard_slice(t, 1, 1, 3).tolist() == [[2, 3], [8, 9]]
    assert pc.shard_slice(t, 1, 1, 3, parts=(3, 3)).tolist() == [[1, 4], [7, 10]]


def test_collectives_over_two_ranks(tmp_path):
    out = tmp_path / "c.pt"
    run_ranks(collectives_rank, 2, str(out))
    seen = torch.load(out)
    assert seen["rows"] == 2
    assert torch.equal(seen["gathered"], torch.arange(12.0).reshape(3, 4) * 2)
    # scatter's backward gathers each rank's cotangent rows: rank 0's x1, rank 1's x2
    assert torch.equal(seen["scatter_grad"], torch.tensor([[1.0] * 4, [1.0] * 4, [2.0] * 4]))
    assert seen["dp_mean"].tolist() == [0.5, 0.5]
    assert seen["copy_grad"].tolist() == [3.0, 3.0]  # 1 + 2 over tp
    assert seen["reduced"].tolist() == [3.0, 3.0]
    assert seen["reduce_grad"].tolist() == [3.0, 3.0]  # identity backward
    assert seen["tp_sum"].tolist() == [1.0, 1.0]


def _configs(name: str) -> tuple:
    """The JAX and port UNet configs of `name` (TINY_ODD_HEADS: TINY with
    one head at its first level)."""
    if name == "TINY_ODD_HEADS":
        return (dataclasses.replace(junet.TINY, num_attention_heads=(1, 2)),
                dataclasses.replace(tunet.TINY, num_attention_heads=(1, 2)))
    return getattr(junet, name), getattr(tunet, name)


@pytest.mark.parametrize("name", ["TINY", "TINY_XL", "TINY_ODD_HEADS"])
def test_tp2_unet_and_lora_grads_match_jax(tmp_path, name):
    """The port's UNet at tp = 2 (remat on), forward and the gradient of
    mean(y^2) with respect to a 'full' LoRA with random up factors, against
    JAX's single-device `unet2d.apply` and `jax.grad`: atol 1e-4 (output)
    and 1e-4 relative to the largest gradient. TINY_ODD_HEADS gives the
    first level one head (SD2.1's 5-head level at tp = 2 in small): its
    attentions stay whole on both ranks, its feed-forward still splits."""
    cfg, tcfg = _configs(name)
    params = junet.init_params(jax.random.key(0), cfg)
    lora = jnet.create_slider_network(jax.random.key(1), params, rank=2, train_method="full")
    lora = {m: {**e, "up": 0.1 * jax.random.normal(jax.random.fold_in(jax.random.key(2), i),
                                                   e["up"].shape)}
            for i, (m, e) in enumerate(sorted(lora.items()))}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ehs = rng.standard_normal((2, 7, cfg.cross_attention_dim)).astype(np.float32)
    t = np.array([10.0, 500.0], np.float32)
    added = None
    if cfg.addition_embed_type:
        added = {"text_embeds": rng.standard_normal((2, 16)).astype(np.float32),
                 "time_ids": np.tile(np.array([64, 64, 0, 0, 64, 64], np.float32), (2, 1))}
    def loss(w):
        y = junet.apply(params, cfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ehs),
                        added_cond=None if added is None else jax.tree.map(jnp.asarray, added),
                        lora=JLora(weights=w, multiplier=jnp.asarray(1.0)))
        return jnp.mean(y * y), y

    (_, jy), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(lora)
    tparams = from_jax_params(jax.tree.map(np.asarray, params))
    tlora = from_jax_params(jax.tree.map(np.asarray, lora))
    inputs = {"x": torch.from_numpy(x), "t": torch.from_numpy(t), "ehs": torch.from_numpy(ehs),
              "added": None if added is None else {k: torch.from_numpy(v)
                                                   for k, v in added.items()}}
    out = tmp_path / "u.pt"
    run_ranks(unet_tp_rank, 2, tcfg, tparams, tlora, inputs, str(out))
    seen = torch.load(out)
    # q, k, v, to_out.0 of every attention with even heads, the two ff
    # linears of every block
    heads = tunet.attention_heads(tcfg)
    assert len(seen["split"]) == 4 * sum(h % 2 == 0 for h in heads.values()) + len(heads)
    np.testing.assert_allclose(seen["y"].numpy(), np.asarray(jy), rtol=0, atol=1e-4)
    ref = from_jax_params(jax.tree.map(np.asarray, jgrads))
    scale = max(float(ref[m][k].abs().max()) for m in ref for k in ("down", "up"))
    for m in ref:
        for k in ("down", "up"):
            np.testing.assert_allclose(seen["grads"][m][k].numpy(), ref[m][k].numpy(),
                                       rtol=0, atol=1e-4 * scale)

