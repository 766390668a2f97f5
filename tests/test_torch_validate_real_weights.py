"""The port's eps goldens (`utils/goldens.py`) and real-weight runbook
(`cli/validate_real_weights.py`) dry-run on tiny snapshots the port writes,
on the CPU: record -> match -> a perturbed UNet fails, through the SD and
the SDXL (added-conditioning) branches; the runbook gives the statuses of
tests/test_real_weights.py::test_real_weight_runbook_dry_run (load PASS,
eps_golden RECORDED then MATCHED, lpips PASS, sweep PASS, single_file SKIP),
and with `--ckpt` on a tiny single file of the snapshot's weights,
single_file PASS."""

import json
import os
from unittest import mock

import numpy as np
import pytest
import torch
from helpers import make_tokenizer_files
from torch_tiny_snapshot import write_tiny_snapshot

from sliders_tpu_torch.cli import validate_real_weights as rb
from sliders_tpu_torch.evals import lpips
from sliders_tpu_torch.models import clip_text, clip_vision, convert, loader, unet2d, vae
from sliders_tpu_torch.models import ldm_checkpoint as ldm
from sliders_tpu_torch.utils.goldens import fixed_unet_probe, record_or_compare_eps_golden


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny tensors gain nothing from torch's thread pool, and beside the
    other test workers its threads oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    root = tmp_path_factory.mktemp("rw")
    return write_tiny_snapshot(root / "sd"), write_tiny_snapshot(root / "sdxl", xl=True)


def test_probe_is_seeded_numpy():
    """The probe's draws are numpy's default_rng(11 / 12 / 13), f32, with
    SDXL's static time ids for a square of 8 x spatial pixels."""
    p = fixed_unet_probe(unet2d.TINY_XL, spatial=8, tokens=5)
    np.testing.assert_array_equal(
        p["x"], np.random.default_rng(11).standard_normal((1, 8, 8, 4), np.float32))
    assert p["ehs"].shape == (1, 5, 32) and p["text_embeds"].shape == (1, 16)
    np.testing.assert_array_equal(p["time_ids"], [[64, 64, 0, 0, 64, 64]])
    assert all(v.dtype == np.float32 for v in p.values())
    assert set(fixed_unet_probe(unet2d.TINY)) == {"x", "t", "ehs"}


@pytest.mark.parametrize("xl", [False, True], ids=["sd", "sdxl"])
def test_eps_golden_record_match_and_fail(snapshots, tmp_path, xl):
    """Record, then match on the recorded probe; a perturbed UNet fails, a
    non-finite one always raises, and a golden without its probe (the JAX
    package's) is refused."""
    load = loader.load_sdxl if xl else loader.load_sd
    m = load(snapshots[xl], dtype=torch.float32)
    golden = str(tmp_path / "g.npz")
    assert record_or_compare_eps_golden(m, golden, spatial=8) == "recorded"
    with np.load(golden) as f:
        assert set(f) == {"eps", "x", "t", "ehs"} | ({"text_embeds", "time_ids"} if xl else set())
        assert f["eps"].shape == (1, 8, 8, 4) and np.isfinite(f["eps"]).all()
    assert record_or_compare_eps_golden(m, golden, spatial=8) == "matched"

    m.unet_params["conv_in"]["bias"] = m.unet_params["conv_in"]["bias"] + 0.05
    with pytest.raises(AssertionError):
        record_or_compare_eps_golden(m, golden, spatial=8)
    m.unet_params["conv_in"]["bias"] = m.unet_params["conv_in"]["bias"] * float("nan")
    with pytest.raises(AssertionError, match="non-finite"):
        record_or_compare_eps_golden(m, str(tmp_path / "nan.npz"), spatial=8)
    assert not os.path.exists(tmp_path / "nan.npz")
    np.savez(tmp_path / "jax.npz", eps=np.zeros((1, 8, 8, 4), np.float32))
    with pytest.raises(ValueError, match="no probe inputs"):
        record_or_compare_eps_golden(m, str(tmp_path / "jax.npz"), spatial=8)


def _score_files(d) -> tuple:
    """A tiny CLIP snapshot and torchvision / lpips .pth files from seeds."""
    vocab = make_tokenizer_files(str(d / "clip"))
    tcfg = clip_text.ClipTextConfig(vocab_size=len(vocab), hidden_size=24, num_layers=2,
                                    num_heads=2, intermediate_size=48, max_positions=16,
                                    eos_token_id=vocab["<|endoftext|>"])
    clip_vision.save_clip_model(str(d / "clip"), clip_vision.init_params(
        torch.Generator().manual_seed(2), clip_vision.TINY_VISION, tcfg),
        clip_vision.TINY_VISION, tcfg)
    alex, lins = lpips.torchvision_state(lpips.init_params(torch.Generator().manual_seed(3)))
    torch.save(alex, d / "alexnet.pth")
    torch.save(lins, d / "lpips_alex.pth")
    return str(d / "clip"), str(d / "alexnet.pth"), str(d / "lpips_alex.pth")


def test_runbook_dry_run(snapshots, tmp_path):
    """The whole runbook on the tiny SD snapshot (3 DDIM steps at 64 px):
    JAX's dry-run statuses, then MATCHED on the second run; with --ckpt on
    the snapshot's weights as one LDM .safetensors (architecture configs
    patched to the tiny ones, as the JAX loader test patches them),
    single_file PASS."""
    snap = snapshots[0]
    clip_dir, alex, lins = _score_files(tmp_path)
    out = tmp_path / "out"
    argv = ["--sd15", snap, "--clip", clip_dir, "--alexnet", alex, "--lpips_lins", lins,
            "--golden", str(tmp_path / "g.npz"), "--out", str(out), "--steps", "3",
            "--image_size", "64", "--device", "cpu"]
    rb.main(rb.build_parser().parse_args(argv))
    results = json.loads((out / "validation.json").read_text())
    # CLIP red / blue is a property of trained weights: a random tiny CLIP may fail it
    assert {k: v["status"] for k, v in results.items() if k != "clip"} == {
        "load": "PASS", "eps_golden": "RECORDED", "single_file": "SKIP", "lpips": "PASS",
        "sweep": "PASS"}
    assert results["clip"]["status"] in ("PASS", "FAIL")
    n_params = sum(t.numel() for t in convert.read_safetensors(
        os.path.join(snap, "unet", "diffusion_pytorch_model.safetensors")).values())
    assert results["load"]["detail"] == f"unet params: {n_params:,}"
    assert os.path.exists(out / "sweep_+0.0.png")

    ckpt = str(tmp_path / "sd.safetensors")
    convert.write_safetensors(ckpt, ldm.to_ldm_state(
        convert.load_component(snap, "unet"), unet2d.TINY, convert.load_component(snap, "vae"),
        vae.TINY, convert.load_component(snap, "text_encoder")))
    te_cfg = loader.clip_config_from_hf(convert.load_component_config(snap, "text_encoder"))
    with mock.patch.object(unet2d, "SD15", unet2d.TINY), \
            mock.patch.object(vae, "SD_VAE", vae.TINY), \
            mock.patch.object(clip_text, "CLIP_L", te_cfg):
        rc = rb.main(rb.build_parser().parse_args(argv[:2] + [
            "--ckpt", ckpt, "--golden", str(tmp_path / "g.npz"), "--out", str(out),
            "--steps", "3", "--image_size", "64", "--device", "cpu"]))
    results = json.loads((out / "validation.json").read_text())
    assert {k: v["status"] for k, v in results.items()} == {
        "load": "PASS", "eps_golden": "MATCHED", "single_file": "PASS", "clip": "SKIP",
        "lpips": "SKIP", "sweep": "PASS"}
    assert rc == 0
