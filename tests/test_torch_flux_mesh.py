"""FLUX training over the process mesh on the CPU (gloo ranks of
`tests/torch_mesh_helpers.run_ranks`) against sliders_tpu:

- the FLUX TINY step, f32, at (dp, tp) = (2, 1), (1, 2) and (2, 2) against
  the JAX unsharded step on the same global batch (2 rows) and JAX's
  draws: the loss within 1e-4 relative, the LoRA within atol 1e-5, t_to
  and the pair equal; the grad norm (the JAX step reports none) within
  1e-4 relative of the port's world-1 step on the same draws;
- `train_flux_slider` at tp = 2 end to end, 64 px, against one process;
- `shard_params` on FLUX paths: the contiguous split of FLUX's
  `ff.net.0.proj` (not GEGLU's halves) and a single block's two-part
  `proj_out` columns, against hand slices, and tp = 4 over TINY's 2 heads
  keeping every block whole.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers import make_tiny_flux_snapshot
from torch_mesh_helpers import flux_cli_rank, flux_step_rank, run_ranks

from sliders_tpu.diffusion import schedulers as js
from sliders_tpu.lora import network as jnet
from sliders_tpu.models import flux as jflux
from sliders_tpu.training import flux_slider as jfs
from sliders_tpu.training import optimizers as jopt
from sliders_tpu.training import text_slider as jts
from sliders_tpu_torch.cli import train_flux_slider as tcli
from sliders_tpu_torch.models import flux
from sliders_tpu_torch.models.convert import from_jax_params
from sliders_tpu_torch.parallel import mesh as pm
from sliders_tpu_torch.training import flux_slider as tfs
from sliders_tpu_torch.utils import pytree

N_STEPS = 4
LR = 1e-4
BATCH = 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _raw_pairs(cfg, n_pairs=2, L=5, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_pairs):
        p = {}
        for role in tfs.ROLES:
            p[f"{role}_t5"] = rng.standard_normal((L, cfg.joint_attention_dim)).astype(np.float32)
            p[f"{role}_pooled"] = rng.standard_normal((cfg.pooled_projection_dim,)).astype(
                np.float32)
        p["guidance_signed"] = np.float32(2.0 if i == 0 else -1.0)
        out.append(p)
    return out


@pytest.fixture(scope="module")
def jax_run():
    """Two JAX steps (TINY, f32, batch 2, an xattn rank-4 ortho-up slider)
    with the draws JAX made, and the port's inputs."""
    params = jflux.init_params(jax.random.key(0), jflux.TINY)
    lora = jnet.create_slider_network(jax.random.key(1), params, rank=4, alpha=1.0,
                                      train_method="xattn", ortho_up=True)
    mask = jnet.trainable_mask(lora, ortho_up=True)
    tx = jopt.make_optimizer("adamw", jopt.make_lr_schedule("constant", LR, 100),
                             trainable_mask=mask)
    step = jfs.make_flux_slider_step(
        jflux.TINY, js.make_flowmatch_sampler(num_steps=N_STEPS, mu=0.5), tx, resolution=64,
        batch_size=BATCH, compute_dtype=jnp.float32, remat=False, donate=False,
        trainable_mask=mask)
    raw = _raw_pairs(jflux.TINY)
    jpairs = jts.stack_prompt_pairs([{k: jnp.asarray(v) for k, v in p.items()} for p in raw])
    state = jts.SliderTrainState.create(jax.random.key(2), lora, tx)
    draws, metrics, loras = [], [], []
    for _ in range(2):
        key = jax.random.fold_in(state.key, state.step)
        k_pair, k_t, k_lat = jax.random.split(key, 3)
        draws.append((int(jax.random.randint(k_pair, (), 0, len(raw))),
                      int(jax.random.randint(k_t, (), 1, N_STEPS)),
                      torch.from_numpy(np.array(jax.random.normal(
                          k_lat, (BATCH, 16, jflux.TINY.in_channels)), np.float32))))
        state, m = step(state, params, jpairs)
        metrics.append({k: float(m[k]) for k in ("loss", "t_to", "pair")})
        loras.append(from_jax_params(_np(state.lora)))
    spec = {"params": from_jax_params(_np(params)), "lora": from_jax_params(_np(lora)),
            "pairs": jts.stack_prompt_pairs(raw), "draws": draws, "lr": LR,
            "n_steps": N_STEPS, "batch": BATCH, "remat": True}
    spec["pairs"] = {k: torch.as_tensor(np.asarray(v)) for k, v in spec["pairs"].items()}
    return spec, metrics, loras


@pytest.fixture(scope="module")
def world1(jax_run):
    """The port's unsharded step on the same draws (the grad norms)."""
    from sliders_tpu_torch.diffusion import schedulers as ts
    from sliders_tpu_torch.lora import network as tnet
    from sliders_tpu_torch.training import optimizers as topt
    from sliders_tpu_torch.training.text_slider import SliderTrainState

    spec = jax_run[0]
    mask = tnet.trainable_mask(spec["lora"], ortho_up=True)
    tx = topt.make_optimizer("adamw", topt.make_lr_schedule("constant", LR, 100),
                             trainable_mask=mask)
    step = tfs.make_flux_slider_step(
        flux.TINY, ts.make_flowmatch_sampler(num_steps=N_STEPS, mu=0.5), tx, resolution=64,
        batch_size=BATCH, compute_dtype=torch.float32, remat=True, trainable_mask=mask)
    state = SliderTrainState.create(0, {m: {k: t.clone() for k, t in e.items()}
                                        for m, e in spec["lora"].items()}, tx)
    out = []
    for draws in spec["draws"]:
        state, m = step(state, spec["params"], spec["pairs"], draws=draws)
        out.append(m["grad_norm"])
    return out


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2), (2, 2)])
def test_flux_step_on_mesh_matches_jax(jax_run, world1, tmp_path, dp, tp):
    """The dp x tp step (remat on) against the JAX step (remat off): loss
    within 1e-4 relative, every factor within atol 1e-5 (up and alpha are
    frozen: bit for bit), t_to and the pair equal; the grad norm within
    1e-4 relative of world 1's. Under tp every LoRA module's base weight
    is split."""
    spec, metrics, loras = jax_run
    out = tmp_path / "seen.pt"
    run_ranks(flux_step_rank, dp * tp, dp, tp, spec, str(out), tag=f"flux step {dp}x{tp}")
    saved = torch.load(out)
    for (m, lora), jm, jl, gn, draws in zip(saved["seen"], metrics, loras, world1,
                                            spec["draws"]):
        assert (m["pair"], m["t_to"]) == (int(jm["pair"]), int(jm["t_to"])) == draws[:2]
        assert m["loss"] == pytest.approx(jm["loss"], rel=1e-4)
        assert m["grad_norm"] == pytest.approx(gn, rel=1e-4)
        for name in jl:
            np.testing.assert_allclose(lora[name]["down"].numpy(), jl[name]["down"].numpy(),
                                       rtol=0, atol=1e-5)
            assert torch.equal(lora[name]["up"], spec["lora"][name]["up"])
            assert torch.equal(lora[name]["alpha"], jl[name]["alpha"])
    if tp > 1:
        assert set(spec["lora"]) <= set(saved["split"])


def test_flux_cli_at_tp2_end_to_end(tmp_path):
    """`train_flux_slider` with `tpu.tp: 2` on 2 gloo ranks (64 px, f32,
    rank-2 xattn, 3 iterations) against the same config in one process:
    rank 0 writes the one-process run's files, and the final LoRA is
    within atol 1e-5 of it."""
    snap = make_tiny_flux_snapshot(str(tmp_path / "flux_tiny"))
    (tmp_path / "prompts.yaml").write_text(
        "- target: person\n  positive: very old person\n  unconditional: ''\n"
        "  neutral: person\n  action: enhance\n  guidance_scale: 1\n"
        "  resolution: 64\n  batch_size: 2\n")

    def config(name, tpu):
        path = tmp_path / f"{name}.yaml"
        path.write_text(
            f"prompts_file: {tmp_path / 'prompts.yaml'}\n"
            f"pretrained_model:\n  name_or_path: {snap}\n"
            "network:\n  rank: 2\n  alpha: 1.0\n  training_method: xattn\n"
            "train:\n  precision: float32\n  iterations: 3\n  lr: 0.0001\n"
            "  optimizer: adamw\n  lr_scheduler: constant\n  max_denoising_steps: 3\n"
            f"save:\n  name: f\n  path: {tmp_path / name}\n  per_steps: 1\n"
            f"logging:\n  log_every: 1\ntpu:\n  remat: true\n{tpu}")
        return ["--config_file", str(path), "--device", "cpu", "--t5_len", "16"]

    one = tcli.main(tcli.build_parser().parse_args(config("one", "")))
    out = tmp_path / "tp2.pt"
    run_ranks(flux_cli_rank, 2, config("two", "  tp: 2\n"), str(out), tag="train_flux tp=2")
    two = torch.load(out)
    assert [i for i, _ in two["seen"]] == [0, 1, 2]
    for m in one:
        for k in ("down", "up", "alpha"):
            np.testing.assert_allclose(two["final"][m][k].numpy(), one[m][k].numpy(), rtol=0,
                                       atol=1e-5)
    name = "f_alpha1.0_rank2_xattn"
    files = sorted(os.listdir(tmp_path / "two" / name))
    assert files == sorted(os.listdir(tmp_path / "one" / name))
    assert f"{name}_1steps.safetensors" in files
    md = json.loads((tmp_path / "two" / name / f"{name}_metadata.json").read_text())
    assert md["config"]["tpu"]["tp"] == 2


def _rank_mesh(r: int, tp: int):
    """Rank r's view of a 1 x tp mesh, without a process group."""
    return pm.Mesh(shape={"dp": 1, "tp": tp}, coords={"dp": 0, "tp": r}, groups={}, rank=r,
                   world=tp, backend="none")


def test_shard_params_flux_traps():
    """FLUX's `ff.net.0.proj` splits contiguously (rank r: hidden rows [r *
    4D/2, (r + 1) * 4D/2)); a single block's `proj_out` keeps the columns
    [attention slice r | D + MLP slice r]; the adaLN modulations, the
    embedders and the model-level `proj_out` stay whole; both ranks'
    slices reassemble the whole weight. At tp = 4 TINY's 2 heads keep every
    attention unit whole (its MLPs still split)."""
    cfg = flux.TINY
    whole = pytree.flatten(flux.init_params(torch.Generator().manual_seed(0), cfg))
    D, H = cfg.inner_dim, 4 * cfg.inner_dim
    shards = []
    for r in range(2):
        mesh = _rank_mesh(r, 2)
        tree = pytree.flatten(flux.keep_blocks(pytree.unflatten(whole), pm.tp_keep(mesh)))
        shards.append(tree)
        ff = whole["transformer_blocks.0.ff.net.0.proj.weight"]
        assert torch.equal(tree["transformer_blocks.0.ff.net.0.proj.weight"],
                           ff[r * H // 2:(r + 1) * H // 2])
        assert torch.equal(tree["transformer_blocks.1.ff_context.net.0.proj.bias"],
                           whole["transformer_blocks.1.ff_context.net.0.proj.bias"][
                               r * H // 2:(r + 1) * H // 2])
        po = whole["single_transformer_blocks.1.proj_out.weight"]
        hand = torch.cat([po[:, r * D // 2:(r + 1) * D // 2],
                          po[:, D + r * H // 2:D + (r + 1) * H // 2]], dim=1)
        assert torch.equal(tree["single_transformer_blocks.1.proj_out.weight"], hand)
        assert mesh.tp_parts["single_transformer_blocks.1.proj_out"] == (D, H)
        assert "transformer_blocks.0.ff.net.0.proj" not in mesh.tp_parts
        for path in ("transformer_blocks.0.norm1.linear.weight", "x_embedder.weight",
                     "proj_out.weight", "single_transformer_blocks.0.proj_out.bias",
                     "transformer_blocks.0.attn.to_out.0.bias"):
            assert tree[path] is whole[path]
        assert tree["transformer_blocks.0.attn.add_k_proj.weight"].shape == (D // 2, D)
        assert tree["transformer_blocks.0.attn.to_add_out.weight"].shape == (D, D // 2)
    for path, w in whole.items():
        a, b = shards[0][path], shards[1][path]
        if a is w:
            continue
        if path.startswith("single_transformer_blocks") and path.endswith("proj_out.weight"):
            rebuilt = torch.cat([a[:, :D // 2], b[:, :D // 2], a[:, D // 2:], b[:, D // 2:]], 1)
        else:
            rebuilt = torch.cat([a, b], 0 if a.shape[0] != w.shape[0] else 1)
        assert torch.equal(rebuilt, w), path
    mesh4 = _rank_mesh(0, 4)
    tree4 = pytree.flatten(flux.keep_blocks(pytree.unflatten(whole), pm.tp_keep(mesh4)))
    assert tree4["transformer_blocks.0.attn.to_q.weight"] is whole[
        "transformer_blocks.0.attn.to_q.weight"]
    assert tree4["single_transformer_blocks.0.proj_mlp.weight"] is whole[
        "single_transformer_blocks.0.proj_mlp.weight"]
    assert tree4["transformer_blocks.0.ff.net.2.weight"].shape == (D, H // 4)
    assert not any(m.startswith("single_transformer_blocks") for m in mesh4.tp_split)
