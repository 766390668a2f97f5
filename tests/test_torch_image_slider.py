"""The port's image-slider training against sliders_tpu on the CPU: the
step (`training/image_slider.py`) held against the JAX step on the same
weights, images and draws (SD's TINY UNet and TINY_XL, each with the TINY
VAE), the fused [+s, -s] multiplier, the refusals, and the CLI end to end
on the tiny snapshot (save names and cadence, files the JAX package reads,
`--stylecheck`, `--fleet` without `--stylecheck`, `--device`).

The step parity runs in f32 at 32 px with lr 1e-4, as the text step's does
(`tests/test_torch_training.py`: Adam turns ULP-level gradient noise on the
zero-initialised up factors into lr-sized steps, so atol 1e-5 on the LoRA
is meaningful only at a small lr).
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers import make_tiny_snapshot
from PIL import Image

from sliders_tpu.cli import train_image_slider as jcli
from sliders_tpu.diffusion import make_sampler as jmake_sampler
from sliders_tpu.diffusion import make_schedule as jmake_schedule
from sliders_tpu.lora import io as jio
from sliders_tpu.lora import network as jnet
from sliders_tpu.models import unet2d as junet
from sliders_tpu.models import vae as jvae
from sliders_tpu.training import image_slider as jis
from sliders_tpu.training import optimizers as jopt
from sliders_tpu.training.text_slider import SliderTrainState as JaxState
from sliders_tpu_torch.cli import train_image_slider as tcli
from sliders_tpu_torch.diffusion import schedulers as tsched
from sliders_tpu_torch.lora import network as tnet
from sliders_tpu_torch.models import unet2d as tunet
from sliders_tpu_torch.models import vae as tvae
from sliders_tpu_torch.models.convert import from_jax_params
from sliders_tpu_torch.ops.basic import SliderLora
from sliders_tpu_torch.serving.server import encode_png
from sliders_tpu_torch.training import driver as tdriver
from sliders_tpu_torch.training import image_slider as tis
from sliders_tpu_torch.training import optimizers as topt
from sliders_tpu_torch.training.text_slider import SliderTrainState

MAX_STEPS = 10
LR = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(xl: bool, seed: int = 4):
    """uint8 images of a pair (as the CLI quantises them) and the prompt
    embeddings, as numpy."""
    rng = np.random.default_rng(seed)
    b = {"images_low": rng.integers(0, 200, (1, 32, 32, 3), dtype=np.uint8),
         "images_high": rng.integers(50, 256, (1, 32, 32, 3), dtype=np.uint8),
         "positive": rng.standard_normal((7, 32)).astype(np.float32),
         "neutral": rng.standard_normal((7, 32)).astype(np.float32)}
    if xl:
        b["pooled_positive"] = rng.standard_normal((16,)).astype(np.float32)
        b["pooled_neutral"] = rng.standard_normal((16,)).astype(np.float32)
        b["time_ids"] = np.array([32, 32, 0, 0, 32, 32], np.float32)
    return b


def _jax_draws(state, B: int, latent_hw: tuple):
    """The JAX step's draws, recomputed from its key exactly as
    image_slider.py:88-112 makes them."""
    key = jax.random.fold_in(state.key, state.step)
    k_t, k_post, k_noise = jax.random.split(key, 3)
    t_to = jax.random.randint(k_t, (), 1, MAX_STEPS - 1)
    eps = jax.random.normal(k_post, (2 * B, *latent_hw, 4), jnp.float32)
    noise = jax.random.normal(k_noise, (B, *latent_hw, 4), jnp.float32)
    return int(t_to), torch.from_numpy(np.array(eps)), torch.from_numpy(np.array(noise))


@pytest.mark.parametrize("xl", [False, True])
def test_step_matches_jax(xl):
    """Three steps at scales 1, 2 and 1 of the port's step against JAX
    make_image_slider_step on the same weights and the draws JAX made: the
    loss within 1e-5 relative, the LoRA after each update within atol 1e-5,
    the alphas bit for bit."""
    ucfg, tucfg = (junet.TINY_XL, tunet.TINY_XL) if xl else (junet.TINY, tunet.TINY)
    uparams = junet.init_params(jax.random.key(0), ucfg)
    vparams = jvae.init_params(jax.random.key(1), jvae.TINY)
    lora = jnet.create_slider_network(jax.random.key(2), uparams, rank=2,
                                      train_method="noxattn", init_a=math.sqrt(5))
    jtx = jopt.make_optimizer("adamw", jopt.make_lr_schedule("constant", LR, 100),
                              trainable_mask=jnet.trainable_mask(lora))
    sched = jmake_schedule()
    jstep = jis.make_image_slider_step(
        ucfg, jvae.TINY, sched, jmake_sampler(sched, "ddim", MAX_STEPS), jtx,
        max_denoising_steps=MAX_STEPS, compute_dtype=jnp.float32, remat=False, is_xl=xl,
        donate=False)
    jstate = JaxState.create(jax.random.key(3), lora, jtx)

    tlora = from_jax_params(_np(lora))
    ttx = topt.make_optimizer("adamw", topt.make_lr_schedule("constant", LR, 100),
                              trainable_mask=tnet.trainable_mask(tlora))
    tsch = tsched.make_schedule()
    tstep = tis.make_image_slider_step(
        tucfg, tvae.TINY, tsch, tsched.make_sampler(tsch, "ddim", MAX_STEPS), ttx,
        max_denoising_steps=MAX_STEPS, compute_dtype=torch.float32, remat=False, is_xl=xl)
    tstate = SliderTrainState.create(0, tlora, ttx)
    tu, tv = from_jax_params(_np(uparams)), from_jax_params(_np(vparams))

    nb = _batch(xl)
    tbatch = {k: torch.from_numpy(v) for k, v in nb.items()}
    for scale in (1.0, 2.0, 1.0):
        draws = _jax_draws(jstate, 1, (16, 16))
        jstate, jm = jstep(jstate, uparams, vparams,
                           {**{k: jnp.asarray(v) for k, v in nb.items()},
                            "scale": jnp.asarray(scale, jnp.float32)})
        tstate, tm = tstep(tstate, tu, tv, {**tbatch, "scale": scale}, draws=draws)
        assert tm["t_to"] == int(jm["t_to"]) == draws[0]
        assert tm["scale"] == float(jm["scale"]) == scale
        assert tm["phase_ms"] is None  # device times exist only on CUDA
        assert tm["loss"] == pytest.approx(float(jm["loss"]), rel=1e-5)
        ref = from_jax_params(_np(jstate.lora))
        for m in ref:
            for k in ("down", "up"):
                np.testing.assert_allclose(tstate.lora[m][k].numpy(), ref[m][k].numpy(),
                                           rtol=0, atol=1e-5)
            assert torch.equal(tstate.lora[m]["alpha"], ref[m]["alpha"])
    assert tstate.step == int(jstate.step) == 3


def _port_step(remat: bool, **kw):
    params = tunet.init_params(torch.Generator().manual_seed(0), tunet.TINY)
    vparams = tvae.init_params(torch.Generator().manual_seed(1), tvae.TINY)
    lora = tnet.create_slider_network(torch.Generator().manual_seed(2), params, rank=2,
                                      train_method="noxattn", init_a=math.sqrt(5))
    tx = topt.make_optimizer("adamw", topt.make_lr_schedule("constant", LR, 100),
                             trainable_mask=tnet.trainable_mask(lora))
    sch = tsched.make_schedule()
    step = tis.make_image_slider_step(
        tunet.TINY, tvae.TINY, sch, tsched.make_sampler(sch, "ddim", MAX_STEPS), tx,
        max_denoising_steps=MAX_STEPS, compute_dtype=torch.float32, remat=remat, **kw)
    return step, SliderTrainState.create(7, lora, tx), params, vparams


def test_step_remat_and_own_draws():
    """remat recomputes the transformer blocks in the backward: the same
    loss and LoRA (rel 1e-6). The step's own draws come from (seed, step):
    `image_step_draws` gives them, t_to in [1, max_steps - 1)."""
    batch = {k: torch.from_numpy(v) for k, v in _batch(False).items()}
    batch["scale"] = 1.5
    (s_off, st_off, p, v), (s_on, st_on, _, _) = _port_step(False), _port_step(True)
    st_off, m_off = s_off(st_off, p, v, batch)
    st_on, m_on = s_on(st_on, p, v, batch)
    assert m_on["loss"] == pytest.approx(m_off["loss"], rel=1e-6)
    for m in st_on.lora:
        np.testing.assert_allclose(st_on.lora[m]["down"].numpy(), st_off.lora[m]["down"].numpy(),
                                   rtol=1e-6, atol=1e-9)
    t_to, eps, noise = tis.image_step_draws(7, 0, MAX_STEPS, (1, 16, 16, 4))
    assert m_off["t_to"] == t_to and 1 <= t_to < MAX_STEPS - 1
    assert eps.shape == (2, 16, 16, 4) and noise.shape == (1, 16, 16, 4)
    # the draws of another step differ; those of one step repeat
    assert not torch.equal(tis.image_step_draws(7, 1, MAX_STEPS, (1, 16, 16, 4))[1], eps)
    assert torch.equal(tis.image_step_draws(7, 0, MAX_STEPS, (1, 16, 16, 4))[1], eps)
    with pytest.raises(ValueError, match="t_to"):
        s_off(st_off, p, v, batch, draws=(MAX_STEPS - 1, eps, noise))


def test_per_row_multiplier_equals_two_scalar_calls():
    """The fused batch at multipliers [+s, -s] equals the two sides' calls
    at scalar multipliers +s and -s (atol 1e-5 of the output's scale)."""
    params = tunet.init_params(torch.Generator().manual_seed(0), tunet.TINY)
    lora = tnet.create_slider_network(torch.Generator().manual_seed(1), params, rank=4,
                                      train_method="noxattn", init_a=math.sqrt(5))
    lora = {m: {**e, "up": e["up"] + 0.03} for m, e in lora.items()}
    g = torch.Generator().manual_seed(2)
    x, ehs = torch.randn(2, 16, 16, 4, generator=g), torch.randn(2, 7, 32, generator=g)
    t = torch.tensor(500.0)
    fused = tunet.apply(params, tunet.TINY, x, t, ehs,
                        lora=SliderLora(weights=lora, multiplier=torch.tensor([2.0, -2.0])))
    hi = tunet.apply(params, tunet.TINY, x[:1], t, ehs[:1],
                     lora=SliderLora(weights=lora, multiplier=2.0))
    lo = tunet.apply(params, tunet.TINY, x[1:], t, ehs[1:],
                     lora=SliderLora(weights=lora, multiplier=-2.0))
    scale = float(fused.abs().max())
    torch.testing.assert_close(fused[:1], hi, rtol=0, atol=1e-5 * scale)
    torch.testing.assert_close(fused[1:], lo, rtol=0, atol=1e-5 * scale)
    assert not torch.allclose(hi, lo)


def test_step_refusals():
    """chunk > 1 names ROADMAP item 18. A mesh is ported: `mesh=` builds
    the sharded step, which on a single-process mesh is the unsharded step,
    bit for bit."""
    from sliders_tpu_torch.parallel.mesh import make_mesh

    batch = {k: torch.from_numpy(v) for k, v in _batch(False).items()}
    batch["scale"] = 1.5
    (s0, st0, p, v), (s1, st1, _, _) = _port_step(False), _port_step(False, mesh=make_mesh())
    st0, m0 = s0(st0, p, v, batch)
    st1, m1 = s1(st1, p, v, batch)
    assert (m1["loss"], m1["grad_norm"]) == (m0["loss"], m0["grad_norm"])
    assert all(torch.equal(st1.lora[m][k], st0.lora[m][k]) for m in st0.lora for k in st0.lora[m])
    with pytest.raises(NotImplementedError, match="item 18"):
        _port_step(False, chunk=2)


def test_to_u8_matches_the_jax_cli():
    """The reader's floats are quantised as the JAX CLI's to_u8 does."""
    x = np.random.default_rng(0).uniform(-1.2, 1.2, (2, 5, 7, 3)).astype(np.float32)
    ref = np.clip((x + 1.0) * 127.5 + 0.5, 0, 255).astype(np.uint8)  # cli/train_image_slider.py:125
    np.testing.assert_array_equal(tdriver.to_u8(x), ref)


# ---------------------------------------------------------------------------
# the CLI on the tiny snapshot
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("image_cli")
    snapshot = make_tiny_snapshot(str(root / "sd_tiny"))
    (root / "prompts.yaml").write_text(
        "- target: ''\n  positive: 'big eyes'\n  unconditional: ''\n  neutral: 'eyes'\n"
        "  guidance_scale: 1\n  resolution: 48\n")
    (root / "config.yaml").write_text(
        f"prompts_file: {root / 'prompts.yaml'}\n"
        f"pretrained_model:\n  name_or_path: {snapshot}\n"
        "network:\n  rank: 2\n  training_method: noxattn\n"
        "train:\n  precision: float32\n  iterations: 5\n  lr: 0.001\n  max_denoising_steps: 5\n"
        f"save:\n  name: eyesize\n  path: {root / 'out'}\n  per_steps: 2\n"
        "logging:\n  log_every: 1\n"
        "tpu:\n  remat: false\n  donate: false\n")
    rng = np.random.default_rng(0)
    for main, n_styles in (("pairs", 0), ("styles", 2)):
        mains = [root / main] if not n_styles else [root / main / f"{i}" for i in range(n_styles)]
        for m in mains:
            for folder, val in (("vsmall", 20), ("small", 60), ("big", 180), ("vbig", 230)):
                os.makedirs(m / folder)
                for name in ("a.png", "b.png", "c.png"):
                    img = (rng.random((40, 48, 3)) * 20 + val).astype(np.uint8)
                    (m / folder / name).write_bytes(encode_png(img))
                # one truncated file, skipped with a warning
                (m / folder / "d.png").write_bytes(encode_png(np.zeros((8, 8, 3), np.uint8))[:40])
    return root


def _argv(root, main="pairs", *extra):
    return ["--config_file", str(root / "config.yaml"), "--folder_main", str(root / main),
            "--folders", "vsmall, small, big, vbig", "--scales", "-2, -1, 1, 2",
            "--resolution", "48", "--device", "cpu", *extra]


def test_cli_end_to_end(cli_root, capsys):
    """Five iterations: `{name}_2steps` and `_last` saves (the JAX CLI's
    cadence), keys the JAX package's load_slider reads, equal to the LoRA
    the CLI returns; the truncated file skipped with its warning."""
    seen = []
    out = tcli.main(tcli.build_parser().parse_args(_argv(cli_root)),
                    on_step=lambda i, state, m: seen.append((i, m)))
    name = "eyesize_alpha1.0_rank2_noxattn"
    assert list(out) == [name]
    run_dir = cli_root / "out" / name
    assert sorted(os.listdir(run_dir)) == [f"{name}_2steps.safetensors",
                                           f"{name}_last.safetensors"]
    assert [i for i, _ in seen] == list(range(5))
    assert {m["scale"] for _, m in seen} <= {1.0, 2.0}
    assert all(math.isfinite(m["loss"]) for _, m in seen)
    text = capsys.readouterr().out
    assert "create LoRA for U-Net: 16 modules." in text and text.count("Saving...") == 2
    assert "step 4: loss*1k=" in text and text.strip().endswith("Done.")

    from sliders_tpu.models import loader as jloader

    jparams = jloader.load_sd(str(cli_root / "sd_tiny")).unet_params
    back = jio.load_slider(str(run_dir / f"{name}_last.safetensors"), jparams)
    final = out[name]
    assert set(back) == set(final)
    for m in final:
        for k in ("down", "up", "alpha"):
            np.testing.assert_array_equal(from_jax_params(_np({m: back[m]}))[m][k].numpy(),
                                          final[m][k].numpy())
        assert float(final[m]["up"].abs().max()) > 0


def test_cli_prompts_file_is_parsed_and_not_applied(cli_root, tmp_path, monkeypatch):
    """--prompts_file is parsed and ignored, as the JAX CLI does
    (sliders_tpu/cli/train_image_slider.py:431 reads config.prompts_file):
    with the flag on another file, training gets the config's prompts."""
    other = tmp_path / "other.yaml"
    other.write_text("- target: 'other'\n  positive: 'small eyes'\n  unconditional: ''\n"
                     "  neutral: 'eyes'\n  guidance_scale: 1\n  resolution: 48\n")
    seen = []
    monkeypatch.setattr(tcli, "train_image_sliders",
                        lambda config, prompts, *a, **k: seen.append((config, prompts)) or {})
    tcli.main(tcli.build_parser().parse_args(_argv(cli_root, "pairs", "--prompts_file",
                                                   str(other))))
    (config, prompts), = seen
    assert config.prompts_file == str(cli_root / "prompts.yaml")
    assert [p.positive for p in prompts] == ["big eyes"]
    assert "--prompts_file" in {a for act in jcli.build_parser()._actions
                                for a in act.option_strings}


def test_cli_stylecheck_and_refusals(cli_root):
    """--stylecheck trains one slider per sorted style folder, saved as
    `{style}_{name}`; --fleet without --stylecheck exits, as the JAX CLI
    does; --device cuda without a card refuses."""
    out = tcli.main(tcli.build_parser().parse_args(_argv(cli_root, "styles", "--stylecheck",
                                                         "1", "--name", "st")))
    names = [f"{i}_st_alpha1.0_rank2_noxattn" for i in range(2)]
    assert list(out) == names
    run_dir = cli_root / "out" / "st_alpha1.0_rank2_noxattn"
    assert sorted(os.listdir(run_dir)) == sorted(f"{n}_{s}.safetensors" for n in names
                                                 for s in ("2steps", "last"))
    # the two style folders hold different images: different sliders
    assert not torch.equal(out[names[0]][next(iter(out[names[0]]))]["down"],
                           out[names[1]][next(iter(out[names[1]]))]["down"])
    with pytest.raises(SystemExit, match="--fleet needs --stylecheck"):
        tcli.main(tcli.build_parser().parse_args(_argv(cli_root, "styles", "--fleet")))
    if not torch.cuda.is_available():
        argv = _argv(cli_root)
        argv[argv.index("--device") + 1] = "0"
        with pytest.raises(RuntimeError, match="--device cpu"):
            tcli.main(tcli.build_parser().parse_args(argv))


def test_cli_flags_match_jax():
    """The JAX CLI's flags, and their defaults, plus --device."""
    jflags = {a.dest: a.default for a in jcli.build_parser()._actions}
    tflags = {a.dest: a.default for a in tcli.build_parser()._actions}
    assert set(tflags) == set(jflags)
    for k in set(jflags) - {"device"}:
        assert tflags[k] == jflags[k], k
    assert tflags["device"] == "0"


def test_cli_reads_pil_pngs_like_the_jax_cli(cli_root, tmp_path):
    """Folders PIL wrote are read by the port without Pillow: the pair the
    port's reader returns is the JAX package's within 1e-5."""
    from sliders_tpu.data.paired_images import PairedImageFolders as JaxFolders
    from sliders_tpu_torch.data.paired_images import PairedImageFolders

    for folder, val in (("low", 30), ("high", 200)):
        os.makedirs(tmp_path / folder)
        Image.fromarray(np.full((30, 20, 3), val, np.uint8)).save(tmp_path / folder / "a.png")
    s, lo, hi = PairedImageFolders(str(tmp_path), ["low", "high"], [-1, 1]).sample_pair(
        np.random.default_rng(0), 16)
    js, jlo, jhi = JaxFolders(str(tmp_path), ["low", "high"], [-1, 1]).sample_pair(
        np.random.default_rng(0), 16)
    assert s == js == 1.0
    np.testing.assert_allclose(lo, jlo, rtol=0, atol=1e-5)
    np.testing.assert_allclose(hi, jhi, rtol=0, atol=1e-5)
