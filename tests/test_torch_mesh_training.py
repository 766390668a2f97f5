"""The port's training steps over a process mesh on the CPU (gloo ranks of
`tests/torch_mesh_helpers.run_ranks`) against sliders_tpu:

- the text step at dp = 2, tp = 2 and dp 2 x tp 2 against the JAX
  single-device step on the same global batch (batch x dp rows) with the
  JAX draws passed in, within the port's single-process parity tolerance
  (`tests/test_torch_training.py::test_step_matches_jax`: atol 1e-5 on the
  loss, the grad norm and the LoRA after each update);
- the image step at dp = 2 against the JAX image step (loss within 1e-5
  relative, the LoRA within atol 1e-5, as
  `tests/test_torch_image_slider.py::test_step_matches_jax`);
- the fleet at dp = 2 (launched with the SLIDERS_* variables) against the
  port's dp = 1 fleet on the same draws; `train_image_slider` and its
  `--stylecheck --fleet` at dp = 2 against one process;
- the SDXL-shaped step on a 2 x 2 mesh against the port's single-process
  step;
- `train_text_slider` under `torch.distributed.run --nproc_per_node 2
  ... --device cpu` on the tiny snapshot, with jax and the JAX package
  unimportable in the ranks.
"""

import math
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_mesh_helpers import (
    fleet_cli_rank,
    free_port,
    image_cli_rank,
    image_step_rank,
    run_config,
    run_ranks,
    text_step,
    text_step_rank,
)
from torch_tiny_snapshot import write_tiny_snapshot

from sliders_tpu.diffusion import make_sampler as jmake_sampler
from sliders_tpu.diffusion import make_schedule as jmake_schedule
from sliders_tpu.lora import network as jnet
from sliders_tpu.models import unet2d as junet
from sliders_tpu.models import vae as jvae
from sliders_tpu.training import image_slider as jis
from sliders_tpu.training import optimizers as jopt
from sliders_tpu.training import text_slider as jts
from sliders_tpu_torch.cli import train_image_slider as icli
from sliders_tpu_torch.lora import io as tio
from sliders_tpu_torch.lora import network as tnet
from sliders_tpu_torch.models import unet2d as tunet
from sliders_tpu_torch.models.convert import from_jax_params
from sliders_tpu_torch.training import text_slider as tts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_STEPS = 5
LR = 1e-4
_JAX_RUNS: dict = {}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pairs(xl: bool, seed: int = 3) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(2):
        p = {k: rng.standard_normal((7, 32)).astype(np.float32)
             for k in ("target", "positive", "neutral", "unconditional")}
        p["guidance_signed"] = np.float32(4.0 if i == 0 else -2.0)
        if xl:
            for k in ("target", "positive", "neutral", "unconditional"):
                p[f"pooled_{k}"] = rng.standard_normal((16,)).astype(np.float32)
            p["time_ids"] = np.array([64, 64, 0, 0, 64, 64], np.float32)
        out.append(p)
    return out


def _jax_text_run(name: str, batch: int):
    """Two JAX single-device steps of the TINY (or TINY_XL) text step at
    `batch` rows, with the draws JAX made (cached per case)."""
    if (name, batch) in _JAX_RUNS:
        return _JAX_RUNS[(name, batch)]
    cfg = getattr(junet, name)
    xl = cfg.addition_embed_type is not None
    params = junet.init_params(jax.random.key(0), cfg)
    lora = jnet.create_slider_network(jax.random.key(1), params, rank=4, alpha=1.0,
                                      train_method="full")
    sched = jmake_schedule()
    sampler = jmake_sampler(sched, "ddim", MAX_STEPS)
    jtx = jopt.make_optimizer("adamw", jopt.make_lr_schedule("constant", LR, 100),
                              trainable_mask=jnet.trainable_mask(lora))
    jstep = jts.make_text_slider_step(
        cfg, sched, sampler, jtx, max_denoising_steps=MAX_STEPS, resolution=64,
        batch_size=batch, compute_dtype=jnp.float32, remat=False, is_xl=xl, donate=False)
    jstate = jts.SliderTrainState.create(jax.random.key(2), lora, jtx)
    raw = _pairs(xl)
    jpairs = jts.stack_prompt_pairs([{k: jnp.asarray(v) for k, v in p.items()} for p in raw])
    draws, metrics, loras = [], [], []
    for _ in range(2):
        key = jax.random.fold_in(jstate.key, jstate.step)
        k_pair, k_t, k_lat, _, k_crop = jax.random.split(key, 5)
        lat = jax.random.normal(k_lat, (batch, 8, 8, 4)) * sampler.init_noise_sigma
        draws.append((int(jax.random.randint(k_pair, (), 0, 2)),
                      int(jax.random.randint(k_t, (), 1, MAX_STEPS)),
                      torch.from_numpy(np.array(lat, np.float32))))
        jstate, jm = jstep(jstate, params, jpairs)
        metrics.append({k: float(jm[k]) for k in ("loss", "grad_norm", "t_to", "pair")})
        loras.append(from_jax_params(_np(jstate.lora)))
    spec = {"cfg": getattr(tunet, name), "params": from_jax_params(_np(params)),
            "lora": from_jax_params(_np(lora)), "pairs": {k: torch.as_tensor(v) for k, v in
                                                          jts.stack_prompt_pairs(raw).items()},
            "draws": draws, "max_steps": MAX_STEPS, "resolution": 64, "batch": batch,
            "lr": LR}
    _JAX_RUNS[(name, batch)] = spec, metrics, loras
    return _JAX_RUNS[(name, batch)]


@pytest.mark.parametrize("dp,tp,remat", [(2, 1, False), (1, 2, True), (2, 2, True)])
def test_text_step_on_a_mesh_matches_jax(tmp_path, dp, tp, remat):
    """Two iterations of the port's text step on a dp x tp mesh against the
    JAX single-device step on the same 2-row global batch (batch x dp rows
    at dp = 2, as `training/driver.py` sizes it; per_device_batch 2 at dp = 1) and
    JAX's draws: the loss, the grad norm and every LoRA leaf after each
    update within atol 1e-5."""
    spec, metrics, loras = _jax_text_run("TINY", 2)
    out = tmp_path / "t.pt"
    run_ranks(text_step_rank, dp * tp, dp, tp, dict(spec, remat=remat), str(out),
              tag=f"text step dp={dp} tp={tp}")
    _assert_run(torch.load(out), metrics, loras)


def _assert_run(seen, metrics, loras):
    for (tm, tlora), jm, ref in zip(seen, metrics, loras):
        assert (tm["t_to"], tm["pair"]) == (jm["t_to"], jm["pair"])
        assert tm["loss"] == pytest.approx(jm["loss"], abs=1e-5)
        assert tm["grad_norm"] == pytest.approx(jm["grad_norm"], abs=1e-5)
        for m in ref:
            for k in ("down", "up", "alpha"):
                np.testing.assert_allclose(tlora[m][k].numpy(), ref[m][k].numpy(), rtol=0,
                                           atol=1e-5)


def test_sdxl_text_step_on_a_2x2_mesh(tmp_path, one_torch_thread):
    """The TINY_XL step (pooled embeddings and time ids split with the rows)
    on a 2 x 2 mesh against the port's single-process step, which
    `tests/test_torch_sdxl.py` holds against the JAX step: the same
    tolerances."""
    gen = torch.Generator().manual_seed(0)
    params = tunet.init_params(gen, tunet.TINY_XL)
    lora = tnet.create_slider_network(gen, params, rank=4, train_method="full")
    pairs = tts.stack_prompt_pairs(_pairs(True))
    draws = [tts.step_draws(0, i, 2, MAX_STEPS, (2, 8, 8, 4), 1.0)[:3] for i in range(2)]
    spec = {"cfg": tunet.TINY_XL, "params": params, "lora": lora, "pairs": pairs,
            "draws": draws, "max_steps": MAX_STEPS, "resolution": 64, "batch": 2, "lr": LR,
            "remat": False}
    step, state = text_step(spec, None)
    metrics, loras = [], []
    for d in draws:
        state, m = step(state, params, pairs, draws=d)
        metrics.append(m)
        loras.append({k: {kk: t.clone() for kk, t in e.items()} for k, e in state.lora.items()})
    out = tmp_path / "x.pt"
    run_ranks(text_step_rank, 4, 2, 2, spec, str(out), tag="SDXL text step dp=2 tp=2")
    _assert_run(torch.load(out), metrics, loras)


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_image_step_at_dp2_matches_jax(tmp_path):
    """Two iterations of the image step at dp = 2 (one of the fused
    [+s, -s] rows a rank) against the JAX image step on the same images
    and draws."""
    ucfg = junet.TINY
    uparams = junet.init_params(jax.random.key(0), ucfg)
    vparams = jvae.init_params(jax.random.key(1), jvae.TINY)
    lora = jnet.create_slider_network(jax.random.key(2), uparams, rank=2,
                                      train_method="noxattn", init_a=math.sqrt(5))
    jtx = jopt.make_optimizer("adamw", jopt.make_lr_schedule("constant", LR, 100),
                              trainable_mask=jnet.trainable_mask(lora))
    sched = jmake_schedule()
    jstep = jis.make_image_slider_step(
        ucfg, jvae.TINY, sched, jmake_sampler(sched, "ddim", 10), jtx, max_denoising_steps=10,
        compute_dtype=jnp.float32, remat=False, donate=False)
    jstate = jts.SliderTrainState.create(jax.random.key(3), lora, jtx)
    rng = np.random.default_rng(4)
    nb = {"images_low": rng.integers(0, 200, (1, 32, 32, 3), dtype=np.uint8),
          "images_high": rng.integers(50, 256, (1, 32, 32, 3), dtype=np.uint8),
          "positive": rng.standard_normal((7, 32)).astype(np.float32),
          "neutral": rng.standard_normal((7, 32)).astype(np.float32)}
    batches, draws, metrics, loras = [], [], [], []
    for scale in (1.0, 2.0):
        key = jax.random.fold_in(jstate.key, jstate.step)
        k_t, k_post, k_noise = jax.random.split(key, 3)
        draws.append((int(jax.random.randint(k_t, (), 1, 9)),
                      torch.from_numpy(np.array(jax.random.normal(k_post, (2, 16, 16, 4)))),
                      torch.from_numpy(np.array(jax.random.normal(k_noise, (1, 16, 16, 4))))))
        jstate, jm = jstep(jstate, uparams, vparams,
                           {**{k: jnp.asarray(v) for k, v in nb.items()},
                            "scale": jnp.asarray(scale, jnp.float32)})
        metrics.append(float(jm["loss"]))
        loras.append(from_jax_params(_np(jstate.lora)))
        batches.append({**{k: torch.from_numpy(v) for k, v in nb.items()}, "scale": scale})
    spec = {"cfg": tunet.TINY, "params": from_jax_params(_np(uparams)),
            "vae": from_jax_params(_np(vparams)), "lora": from_jax_params(_np(lora)),
            "batches": batches, "draws": draws, "max_steps": 10, "lr": LR}
    out = tmp_path / "i.pt"
    run_ranks(image_step_rank, 2, spec, str(out), tag="image step dp=2")
    for (tm, tlora), jl, ref in zip(torch.load(out), metrics, loras):
        assert tm["loss"] == pytest.approx(jl, rel=1e-5)
        for m in ref:
            for k in ("down", "up"):
                np.testing.assert_allclose(tlora[m][k].numpy(), ref[m][k].numpy(), rtol=0,
                                           atol=1e-5)
            assert torch.equal(tlora[m]["alpha"], ref[m]["alpha"])


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_cli")
    snap = write_tiny_snapshot(str(root / "sd_tiny"))
    for name in ("age", "smile"):
        (root / f"{name}.yaml").write_text(
            f"- target: person\n  positive: {name} person\n  unconditional: ''\n"
            "  neutral: person\n  action: enhance\n  guidance_scale: 2\n"
            "  resolution: 64\n  batch_size: 1\n")
    return root, snap


def test_fleet_at_dp2_matches_dp1(snapshot, tmp_path, one_torch_thread):
    """`train_fleet` with K = 2 at dp = 2 (each rank one slider, no
    gradient collective) against the same CLI at dp = 1 (one process): the
    same t_to and pairs, every row's loss and grad norm within atol 1e-6
    and its final LoRA within atol 1e-5 (a row runs in a 1-row UNet call on
    its rank and beside the other row at dp = 1, so the CPU's sums differ
    in the last bits, which Adam turns into lr-sized steps on the
    zero-initialised up factors: the configs train at lr 1e-4, as the
    step parity tests do), and the same file set."""
    from sliders_tpu_torch.cli import train_fleet as tcli

    root, snap = snapshot
    argv = lambda cfg: ["--config_file", cfg, "--prompts_file", str(root / "age.yaml"),  # noqa
                        str(root / "smile.yaml"), "--device", "cpu"]
    cfg1 = run_config(root, snap, "fleet1", 2, "  dp: 2\n")  # one process: runs unsharded
    seen1 = []
    rows1 = tcli.main(tcli.build_parser().parse_args(argv(cfg1)),
                      on_step=lambda i, s, m: seen1.append((i, m)))
    cfg2 = run_config(root, snap, "fleet2", 2, "  dp: 2\n")
    out = tmp_path / "f.pt"
    # launched with the JAX package's variables (SLIDERS_NUM_PROCESSES, ...)
    run_ranks(fleet_cli_rank, 2, argv(cfg2), str(out), tag="train_fleet dp=2",
              launcher="sliders")
    seen2 = torch.load(out)
    for (i1, m1), (i2, m2) in zip(seen1, seen2["metrics"]):
        assert i1 == i2 and m1["t_to"] == m2["t_to"] and m1["pair"] == m2["pair"]
        np.testing.assert_allclose(m2["loss"], m1["loss"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(m2["grad_norm"], m1["grad_norm"], rtol=0, atol=1e-6)
    for r1, r2 in zip(rows1, seen2["rows"]):
        for m in r1:
            for k in ("down", "up", "alpha"):
                np.testing.assert_allclose(r2[m][k].numpy(), r1[m][k].numpy(), rtol=0,
                                           atol=1e-5)
    d1 = root / "fleet1" / "m_alpha1.0_rank2_noxattn_fleet"
    d2 = root / "fleet2" / "m_alpha1.0_rank2_noxattn_fleet"
    names2 = sorted(os.listdir(d2))
    assert sorted(os.listdir(d1)) == names2
    assert "age_alpha1.0_rank2_noxattn_last.safetensors" in names2


def test_image_cli_and_stylecheck_fleet_at_dp2(snapshot, tmp_path, one_torch_thread):
    """`train_image_slider` at dp = 2 (the fused +-s rows one a rank), then
    `--stylecheck --fleet` at dp = 2 (two styles, one a rank), on one
    2-rank process group, against the same CLI calls in one process (dp = 2
    there builds no mesh): every slider within atol 1e-5 (the rows' UNet
    calls split differently, as in the fleet test above), the same files."""
    from sliders_tpu_torch.serving.server import encode_png

    root, snap = snapshot
    rng = np.random.default_rng(0)
    for style in ("s0", "s1"):
        for folder, val in (("low", 40), ("high", 200)):
            os.makedirs(tmp_path / "styles" / style / folder)
            for name in ("a.png", "b.png"):
                img = (rng.random((24, 24, 3)) * 30 + val).astype(np.uint8)
                (tmp_path / "styles" / style / folder / name).write_bytes(encode_png(img))

    def runs(out):
        cfg = run_config(root, snap, out, 2, "  dp: 2\n")
        common = ["--config_file", cfg, "--folders", "low, high", "--scales", "-1, 1",
                  "--resolution", "16", "--device", "cpu"]
        return [common + ["--folder_main", str(tmp_path / "styles" / "s0")],
                common + ["--folder_main", str(tmp_path / "styles"), "--stylecheck", "1",
                          "--fleet"]]

    one = [icli.main(icli.build_parser().parse_args(argv)) for argv in runs("img1")]
    out = tmp_path / "i.pt"
    run_ranks(image_cli_rank, 2, runs("img2"), str(out), tag="train_image_slider dp=2")
    two = torch.load(out)
    for a, b in zip(one, two):
        assert list(a) == list(b)
        for name in a:
            for m in a[name]:
                for k in ("down", "up"):
                    np.testing.assert_allclose(b[name][m][k].numpy(), a[name][m][k].numpy(),
                                               rtol=0, atol=1e-5)
    files = sorted(os.listdir(root / "img2" / "m_alpha1.0_rank2_noxattn"))
    assert files == sorted(os.listdir(root / "img1" / "m_alpha1.0_rank2_noxattn"))
    assert "s1_m_alpha1.0_rank2_noxattn_last.safetensors" in files


BLOCK_JAX = """
import runpy, sys
for name in [m for m in sys.modules if m.split(".")[0] in ("jax", "sliders_tpu")]:
    del sys.modules[name]
sys.modules["jax"] = sys.modules["sliders_tpu"] = None
import torch
torch.set_num_threads(1)
sys.argv = ["train_text_slider"] + sys.argv[1:]
runpy.run_module("sliders_tpu_torch.cli.train_text_slider", run_name="__main__")
"""


def test_text_cli_under_torchrun_without_jax(snapshot, tmp_path, one_torch_thread):
    """`python -m torch.distributed.run --nproc_per_node 2` on the text CLI
    (`tpu.tp: 2`, `--device cpu`, jax and the JAX package unimportable in
    the ranks): one mesh line, one copy of the CLI's lines, rank 0's files
    (the slider saves and the `.dcp` train state, no `.pt`), and the final
    slider, drawn whole on both ranks from the whole weights' shapes, equal
    to a one-process run of the same config within atol 1e-5."""
    root, snap = snapshot
    cfg = run_config(root, snap, "cli2", 3, "  tp: 2\n  state_checkpoint_every: 1\n")
    script = tmp_path / "run_blocked.py"
    script.write_text(BLOCK_JAX)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
         "--master_addr", "localhost", "--master_port", str(free_port()), str(script),
         "--config_file", cfg, "--device", "cpu"],
        capture_output=True, text=True, timeout=60, env=env, cwd=str(tmp_path))
    print(f"[mesh] torchrun train_text_slider: {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert out.count("mesh dp=1 x tp=2: world 2, backend gloo") == 1
    assert out.count("create LoRA for U-Net:") == 1 and out.count("Done.") == 1
    run = root / "cli2" / "m_alpha1.0_rank2_noxattn"
    names = sorted(os.listdir(run))
    assert names == sorted(["m_alpha1.0_rank2_noxattn_last.safetensors",
                            "m_alpha1.0_rank2_noxattn_metadata.json",
                            "m_alpha1.0_rank2_noxattn_trainstate.dcp"])
    # saved after steps 1 and 2 (state steps 2 and 3), both kept
    assert sorted(os.listdir(run / "m_alpha1.0_rank2_noxattn_trainstate.dcp")) == ["2", "3"]

    from sliders_tpu_torch.cli import train_text_slider as tcli

    one = run_config(root, snap, "cli1", 3, "")
    ref = tcli.main(tcli.build_parser().parse_args(["--config_file", one, "--device", "cpu"]))
    params = tunet.init_params(None, tunet.TINY, device="meta")
    got = tio.load_slider(str(run / "m_alpha1.0_rank2_noxattn_last.safetensors"), params)
    for m in ref:
        for k in ("down", "up"):
            np.testing.assert_allclose(got[m][k].numpy(), ref[m][k].numpy(), rtol=0, atol=1e-5)
