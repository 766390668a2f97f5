"""The port's fleet CLIs end to end with `--device cpu` on the tiny snapshot:
`train_fleet` (the files, the metadata, a resume from
`_fleet_trainstate.pt` equal to the uninterrupted run, and the layout of
the JAX `train_fleet` CLI on the same inputs, that CLI run with its step
replaced by a stand-in: only its file names and metadata keys are
compared), `train_fleet`'s refusals, `train_image_slider --stylecheck
--fleet`, and `generate_images --fleet` (its folders, its argument guards
before the model load, and each checkpoint's images against its solo run).
"""

import json
import math
import os

import numpy as np
import pytest
import torch
from helpers import make_tiny_snapshot

from sliders_tpu_torch.cli import generate_images as tgen
from sliders_tpu_torch.cli import train_fleet as tcli
from sliders_tpu_torch.cli import train_image_slider as icli
from sliders_tpu_torch.data.native_loader import decode_png as load_png
from sliders_tpu_torch.lora import io as tio
from sliders_tpu_torch.lora.network import create_slider_network
from sliders_tpu_torch.models import unet2d as tunet
from sliders_tpu_torch.serving.server import encode_png

RUN = "fleet_alpha1.0_rank2_noxattn"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny tensors gain nothing from torch's thread pool, and beside the
    other test workers its threads oversubscribe the CPU; results are held
    to tolerances or compared within one thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
SLIDERS = [f"{n}_alpha1.0_rank2_noxattn" for n in ("age", "smile")]
CONFIG = """prompts_file: {root}/age.yaml
pretrained_model:
  name_or_path: {snapshot}
network:
  rank: 2
  alpha: 1.0
  training_method: noxattn
train:
  precision: float32
  noise_scheduler: ddim
  iterations: 4
  lr: 0.001
  optimizer: {optimizer}
  lr_scheduler: constant
  max_denoising_steps: 5
save:
  name: fleet
  path: {root}/{out}
  per_steps: 2
logging:
  log_every: 1
tpu:
  remat: false
  donate: false
  state_checkpoint_every: 2
"""


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tmp_path_factory.mktemp("fleet_cli")
    snapshot = make_tiny_snapshot(str(r / "sd_tiny"))
    (r / "age.yaml").write_text(
        "- target: person\n  positive: old person\n  unconditional: young person\n"
        "  neutral: person\n  action: enhance\n  guidance_scale: 2\n  resolution: 64\n")
    (r / "smile.yaml").write_text(
        "- target: face\n  positive: smiling face\n  unconditional: frowning face\n"
        "  neutral: face\n  action: enhance\n  guidance_scale: 3\n  resolution: 64\n"
        "- target: person\n  positive: smiling person\n  unconditional: sad person\n"
        "  neutral: person\n  action: erase\n  guidance_scale: 1\n  resolution: 64\n")
    for out, optimizer in (("out", "adamw"), ("jax_out", "adamw"), ("bad", "prodigy")):
        (r / f"{out}.yaml").write_text(CONFIG.format(root=r, snapshot=snapshot, out=out,
                                                     optimizer=optimizer))
    return r


def _argv(root, config="out", *extra):
    return ["--config_file", str(root / f"{config}.yaml"), "--prompts_file",
            str(root / "age.yaml"), str(root / "smile.yaml"), "--device", "cpu", *extra]


def _train(root, *extra, config="out"):
    seen = []
    final = tcli.main(tcli.build_parser().parse_args(_argv(root, config, *extra)),
                      on_step=lambda i, state, m: seen.append((i, m)))
    return final, seen


def test_train_fleet_files_metadata_and_resume(root, capsys):
    """Two sliders, four iterations: `{name}_2steps` and `{name}_last` per
    slider, the fleet metadata and train state; each row's metrics per
    iteration; the `_last` files reload equal to the returned LoRAs; a
    resume from the state saved after step 2 ends bit for bit where the
    uninterrupted run ended."""
    final, seen = _train(root)
    out_dir = root / "out" / f"{RUN}_fleet"
    assert sorted(os.listdir(out_dir)) == sorted(
        [f"{n}_{s}.safetensors" for n in SLIDERS for s in ("2steps", "last")]
        + [f"{RUN}_fleet_metadata.json", f"{RUN}_fleet_trainstate.pt"])
    assert [i for i, _ in seen] == list(range(4))
    assert all(len(m["loss"]) == 2 and all(map(math.isfinite, m["loss"])) for _, m in seen)
    assert all(m["pair"][0] == 0 and m["pair"][1] in (0, 1) for _, m in seen)
    log = capsys.readouterr().out
    assert "fleet: 2 sliders x 16 LoRA modules" in log and "fleet step 3: mean loss*1k=" in log
    assert f"[{SLIDERS[1]}] 2 prompt pair(s)" in log
    meta = json.loads((out_dir / f"{RUN}_fleet_metadata.json").read_text())
    assert meta["sliders"] == SLIDERS and len(meta["prompts"][SLIDERS[1]]) == 2
    assert meta["config"]["save"]["name"] == RUN

    from sliders_tpu_torch.models import loader

    tparams = loader.load_sd(str(root / "sd_tiny"), dtype=torch.float32).unet_params
    for name, lora in zip(SLIDERS, final):
        last = tio.load_slider(str(out_dir / f"{name}_last.safetensors"), tparams)
        assert set(last) == set(lora)
        assert all(torch.equal(last[m][k], lora[m][k]) for m in lora
                   for k in ("down", "up", "alpha"))
        assert any(float(e["up"].abs().max()) > 0 for e in lora.values())
    assert not torch.equal(final[0][next(iter(final[0]))]["down"],
                           final[1][next(iter(final[1]))]["down"])

    state = out_dir / f"{RUN}_fleet_trainstate.pt"
    assert torch.load(state, weights_only=True)["step"] == 3
    resumed, rseen = _train(root, "--resume", str(state))
    assert "fleet resumed from" in capsys.readouterr().out
    assert [i for i, _ in rseen] == [3]
    assert rseen[0][1]["t_to"] == seen[3][1]["t_to"]
    for a, b in zip(resumed, final):
        assert all(torch.equal(a[m][k], b[m][k]) for m in a for k in ("down", "up"))


def test_train_fleet_layout_matches_jax_cli(root, monkeypatch):
    """The JAX CLI on the same config and prompt files (its step a stand-in
    that only counts): the same file names (its train state `.msgpack`
    where the port writes `.pt`) and the same metadata keys."""
    import jax.numpy as jnp

    from sliders_tpu.cli import train_fleet as jcli
    from sliders_tpu.training import fleet as jfleet

    def stub(*a, n_sliders, **k):
        def step(state, unet_params, pairs):
            m = {"loss": jnp.zeros(n_sliders), "t_to": jnp.ones(n_sliders, jnp.int32),
                 "pair": jnp.zeros(n_sliders, jnp.int32), "grad_norm": jnp.zeros(n_sliders)}
            return state.replace(step=state.step + 1), m
        return step

    monkeypatch.setattr(jfleet, "make_fleet_text_step", stub)
    jcli.main(jcli.build_parser().parse_args(
        ["--config_file", str(root / "jax_out.yaml"), "--prompts_file", str(root / "age.yaml"),
         str(root / "smile.yaml")]))
    jdir, tdir = root / "jax_out" / f"{RUN}_fleet", root / "out" / f"{RUN}_fleet"
    if not tdir.exists():
        _train(root)
    jfiles = sorted(f.replace(".msgpack", ".pt") for f in os.listdir(jdir))
    assert jfiles == sorted(os.listdir(tdir))
    jmeta = json.loads((jdir / f"{RUN}_fleet_metadata.json").read_text())
    tmeta = json.loads((tdir / f"{RUN}_fleet_metadata.json").read_text())
    assert set(jmeta) == set(tmeta) == {"sliders", "prompts", "config"}
    assert jmeta["sliders"] == tmeta["sliders"]
    assert set(jmeta["prompts"]) == set(tmeta["prompts"])
    for name in jmeta["prompts"]:
        assert [set(p) for p in jmeta["prompts"][name]] == [set(p) for p in tmeta["prompts"][name]]
    assert set(jmeta["config"]) == set(tmeta["config"])
    for section, values in jmeta["config"].items():
        if isinstance(values, dict):
            assert set(values) == set(tmeta["config"][section]), section


def test_train_fleet_refusals(root, tmp_path):
    with pytest.raises(NotImplementedError, match="couple fleet rows"):
        _train(root, config="bad")
    msgpack = tmp_path / "x_fleet_trainstate.msgpack"
    msgpack.write_bytes(b"\x80")
    with pytest.raises(ValueError, match="item 15"):
        _train(root, "--resume", str(msgpack))
    body = (root / "out.yaml").read_text()
    (tmp_path / "dp.yaml").write_text(body.replace("tpu:\n", "tpu:\n  dp: 2\n", 1))
    with pytest.raises(NotImplementedError, match="item 15"):
        tcli.main(tcli.build_parser().parse_args(
            ["--config_file", str(tmp_path / "dp.yaml"), "--prompts_file",
             str(root / "age.yaml"), "--device", "cpu"]))
    smile = (root / "smile.yaml").read_text()
    for new, match in (("resolution: 64\n  dynamic_resolution: true", "dynamic_resolution"),
                       ("resolution: 128", "ONE .resolution, batch. bucket")):
        (tmp_path / "smile.yaml").write_text(smile.replace("resolution: 64", new, 1))
        with pytest.raises(ValueError, match=match):
            tcli.main(tcli.build_parser().parse_args(
                ["--config_file", str(root / "out.yaml"), "--prompts_file",
                 str(root / "age.yaml"), str(tmp_path / "smile.yaml"), "--device", "cpu"]))
    with pytest.raises(SystemExit, match="one name per"):
        _train(root, "--names", "a,b,c")


def test_stylecheck_fleet(root, tmp_path):
    """`train_image_slider --stylecheck 1 --fleet`: every sorted style
    folder's slider in one step (two rows a step), saved as
    `{style}_{name}` with the solo CLI's cadence; the two sliders differ."""
    rng = np.random.default_rng(1)
    for style in ("b", "a"):
        for folder, val in (("low", 40), ("high", 200)):
            os.makedirs(tmp_path / "styles" / style / folder)
            for f in ("x.png", "y.png"):
                img = (rng.random((40, 40, 3)) * 30 + val + (style == "b") * 20).astype(np.uint8)
                (tmp_path / "styles" / style / folder / f).write_bytes(encode_png(img))
    config = (root / "out.yaml").read_text().replace(f"{root}/out", str(tmp_path / "img"))
    (tmp_path / "img.yaml").write_text(config)
    seen = []
    out = icli.main(icli.build_parser().parse_args(
        ["--config_file", str(tmp_path / "img.yaml"), "--folder_main",
         str(tmp_path / "styles"), "--folders", "low, high", "--scales", "-1, 1",
         "--resolution", "32", "--device", "cpu", "--stylecheck", "1", "--fleet",
         "--name", "st"]), on_step=lambda i, state, m: seen.append((i, m)))
    names = [f"{s}_st_alpha1.0_rank2_noxattn" for s in ("a", "b")]
    assert list(out) == names
    run_dir = tmp_path / "img" / "st_alpha1.0_rank2_noxattn"
    assert sorted(os.listdir(run_dir)) == sorted(f"{n}_{s}.safetensors" for n in names
                                                 for s in ("2steps", "last"))
    assert [i for i, _ in seen] == [0, 1, 2, 3]
    assert all(len(m["loss"]) == 2 and all(map(math.isfinite, m["loss"])) for _, m in seen)
    assert all(set(m["scale"]) <= {1.0} for _, m in seen)
    a, b = (out[n] for n in names)
    assert not any(torch.equal(a[m]["down"], b[m]["down"]) for m in a)


# ---------------------------------------------------------------------------
# generate_images --fleet
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sliders(root):
    paths = []
    for name, seed, rank in (("age_alpha1.0_rank2_noxattn_last", 1, 2),
                             ("eyes_alpha1.0_rank3_noxattn_last", 2, 3)):
        gen = torch.Generator().manual_seed(seed)
        w = create_slider_network(gen, tunet.init_params(gen, tunet.TINY), rank=rank,
                                  train_method="noxattn")
        for e in w.values():
            e["up"] = torch.randn(e["up"].shape, generator=gen) * 0.5
        path = str(root / f"{name}.safetensors")
        tio.save_slider(path, w)
        paths.append(path)
    (root / "prompts.csv").write_text('case_number,prompt,evaluation_seed\n'
                                      '3,"a photo of a person, smiling",7\n5,a cat,8\n')
    return paths


def _generate(root, out, *extra):
    argv = ["--base", str(root / "sd_tiny"), "--prompts_path", str(root / "prompts.csv"),
            "--save_path", str(root / out), "--device", "cpu", "--precision", "float32",
            "--image_size", "64", "--ddim_steps", "3", "--num_samples", "2",
            "--scales=-2,0,1", *extra]
    return tgen.main(tgen.build_parser().parse_args(argv))


def test_generate_fleet_against_solo_runs(root, sliders):
    """`--fleet a --fleet b`: one folder per checkpoint, the scorers' layout
    in each, and every PNG within one level of 255 of the checkpoint's solo
    `--model_name` run (the fleet's rows take the per-row stacked adapters,
    the solo run the unstacked one: f32 sums in another order)."""
    out = _generate(root, "fleet", "--fleet", sliders[0], "--fleet", sliders[1])
    stems = [os.path.basename(p).replace(".safetensors", "") for p in sliders]
    assert out["folders"] == [str(root / "fleet" / s) for s in stems]
    assert [c for c, _ in out["cases"]] == [3, 5]
    for path, stem in zip(sliders, stems):
        solo = _generate(root, "solo", "--model_name", path)
        assert solo["folders"] == [str(root / "solo" / stem)]
        folder = root / "fleet" / stem
        assert sorted(os.listdir(folder)) == sorted(["-2", "0", "1", "all"])
        for sub in ("-2", "0", "1", "all"):
            files = sorted(os.listdir(folder / sub))
            assert files == ["3_0.png", "3_1.png", "5_0.png", "5_1.png"]
            for f in files:
                a = load_png((folder / sub / f).read_bytes())
                b = load_png((root / "solo" / stem / sub / f).read_bytes())
                assert a.shape == b.shape
                assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, (stem, sub, f)
    # the two sliders share the per-sample noise: equal at scale 0, apart at -2
    f0 = [load_png((root / "fleet" / s / "0" / "3_0.png").read_bytes()) for s in stems]
    f2 = [load_png((root / "fleet" / s / "-2" / "3_0.png").read_bytes()) for s in stems]
    assert np.array_equal(f0[0], f0[1]) and not np.array_equal(f2[0], f2[1])


def test_generate_fleet_guards_run_before_the_load(root, sliders, tmp_path):
    """Duplicate basenames and sweeps that differ without --scales exit
    before the model load (the base does not exist)."""
    common = ["--base", str(tmp_path / "nonexistent"), "--prompts_path", "/nonexistent.csv",
              "--save_path", str(tmp_path), "--device", "cpu"]
    d1, d2 = tmp_path / "a", tmp_path / "b"
    d1.mkdir()
    d2.mkdir()
    for d in (d1, d2):
        (d / "ageslider_last.pt").write_bytes(b"")
    with pytest.raises(SystemExit, match="share basename"):
        tgen.main(tgen.build_parser().parse_args(
            common + ["--fleet", str(d1 / "ageslider_last.pt"),
                      "--fleet", str(d2 / "ageslider_last.pt")]))
    hs = tmp_path / "thing_hspace_last.pt"
    hs.write_bytes(b"")
    with pytest.raises(SystemExit, match="different scale sweeps"):
        tgen.main(tgen.build_parser().parse_args(common + ["--fleet", str(hs),
                                                           "--fleet", sliders[0]]))
    with pytest.raises(NotImplementedError, match="item 15"):
        tgen.main(tgen.build_parser().parse_args(common + ["--fleet", sliders[0], "--dp", "2"]))
