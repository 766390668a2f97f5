"""The port's `generate_images` CLI on the CPU: end to end on the tiny
snapshot (the folder and file layout, the `all/` grid, `--compose` naming,
`--fleet` conflicts, the `--dp 2` refusal); its name parsing and sweep inference
against the JAX CLI's functions; the scale-folder expression against
literal names; the CSV reader against pandas.read_csv; the committed
reference slider fixture through the port's loader; and the CLI, SDXL-Turbo
sampling and the three examples in a process where jax, the JAX package,
pandas and PIL cannot be imported (the card's machine has none of them)."""

import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from helpers import make_tiny_snapshot
from PIL import Image

from sliders_tpu.cli import generate_images as jgen
from sliders_tpu.lora import io as jio
from sliders_tpu.models import unet2d as junet
from sliders_tpu_torch.cli import generate_images as tgen
from sliders_tpu_torch.lora import io as tio
from sliders_tpu_torch.lora.network import create_slider_network
from sliders_tpu_torch.models import unet2d as tunet
from sliders_tpu_torch.models.convert import from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CSV = ('case_number,prompt,evaluation_seed,extra\n'
       '0,"a photo of a person, smiling",11.0,x\n'
       '1,,12,y\n'
       '\n'
       '2,"he said ""hi""",13,z\n'
       '3,None,14.0,w\n'
       '4, leading space,15,v\n')


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tmp_path_factory.mktemp("generate")
    make_tiny_snapshot(str(r / "sd_tiny"))
    (r / "prompts.csv").write_text('case_number,prompt,evaluation_seed\n'
                                   '3,"a photo of a person, smiling",7\n'
                                   '5,a cat,8.0\n'
                                   '9,skipped,9\n')
    for name, seed, rank in (("age_alpha1.0_rank2_noxattn_last", 1, 2),
                             ("eyes_alpha1.0_rank3_noxattn_last", 2, 3)):
        gen = torch.Generator().manual_seed(seed)
        w = create_slider_network(gen, tunet.init_params(gen, tunet.TINY), rank=rank,
                                  train_method="noxattn")
        for e in w.values():
            e["up"] = torch.randn(e["up"].shape, generator=gen) * 0.5
        tio.save_slider(str(r / f"{name}.safetensors"), w)
    return r


def _run(root, *extra):
    argv = ["--base", str(root / "sd_tiny"), "--prompts_path", str(root / "prompts.csv"),
            "--save_path", str(root / "out"), "--device", "cpu", "--precision", "float32",
            "--image_size", "64", "--ddim_steps", "2", "--till_case", "8", *extra]
    return tgen.main(tgen.build_parser().parse_args(argv))


def _png(path):
    return np.asarray(Image.open(path))


def test_cli_writes_the_scorers_layout(root):
    """Per CSV row in [from_case, till_case] and sample i: one PNG per scale
    folder and the sweep side by side under all/; the slider changes the
    image; the sweep is the one the file name implies (-2..2) unless
    --scales is given."""
    out = _run(root, "--model_name", str(root / "age_alpha1.0_rank2_noxattn_last.safetensors"),
               "--num_samples", "2", "--scales=-1,0,0.5,1")
    folder = root / "out" / "age_alpha1.0_rank2_noxattn_last"
    assert out["folders"] == [str(folder)] and [c for c, _ in out["cases"]] == [3, 5]
    assert sorted(os.listdir(folder)) == sorted(["-1", "0", "half", "1", "all"])
    for sub in os.listdir(folder):
        assert sorted(os.listdir(folder / sub)) == ["3_0.png", "3_1.png", "5_0.png", "5_1.png"]
    for case in (3, 5):
        for i in (0, 1):
            row = [_png(folder / s / f"{case}_{i}.png") for s in ("-1", "0", "half", "1")]
            grid = _png(folder / "all" / f"{case}_{i}.png")
            # the TINY VAE decodes 64 px latents (8 x 8) to 16 x 16
            assert row[0].shape == (16, 16, 3) and grid.shape == (16, 4 * 16, 3)
            np.testing.assert_array_equal(grid, np.concatenate(row, axis=1))
            assert not np.array_equal(row[0], row[3])  # the scale changes the image
    # samples differ (seed + i * 1000), cases differ
    assert not np.array_equal(_png(folder / "0" / "3_0.png"), _png(folder / "0" / "3_1.png"))
    assert not np.array_equal(_png(folder / "0" / "3_0.png"), _png(folder / "0" / "5_0.png"))
    # the default sweep of a noxattn slider, under euler_a without CFG
    out = _run(root, "--model_name", str(root / "eyes_alpha1.0_rank3_noxattn_last.safetensors"),
               "--scheduler", "euler_a", "--guidance_scale", "1", "--start_noise", "700")
    assert sorted(os.listdir(root / "out" / "eyes_alpha1.0_rank3_noxattn_last")) == \
        sorted(["-2", "-1", "0", "1", "2", "all"])


def test_cli_compose_and_refusals(root):
    """--compose names its folder by the adapters and their scales and sweeps
    0, 1 by default; at 0 it is the base model. --dp 2 names ROADMAP item
    15; --compose with --model_name or --fleet, and --fleet with
    --model_name, exit before the model load."""
    a, b = (str(root / f"{n}_alpha1.0_rank{r}_noxattn_last.safetensors")
            for n, r in (("age", 2), ("eyes", 3)))
    _run(root, "--compose", f"{a}:1", "--compose", f"{b}:-1.5", "--scheduler", "lms")
    folder = root / "out" / ("compose_age_alpha1.0_rank2_noxattn_last_1+"
                             "eyes_alpha1.0_rank3_noxattn_last_-1.5")
    assert sorted(os.listdir(folder)) == ["0", "1", "all"]
    _run(root, "--scales", "0", "--scheduler", "lms")  # the base model
    np.testing.assert_array_equal(_png(folder / "0" / "3_0.png"),
                                  _png(root / "out" / "base" / "0" / "3_0.png"))
    assert not np.array_equal(_png(folder / "1" / "3_0.png"), _png(folder / "0" / "3_0.png"))
    for extra in (["--compose", f"{a}:1"], ["--model_name", b]):
        with pytest.raises(SystemExit, match="conflict"):
            tgen.main(tgen.build_parser().parse_args(
                ["--base", "/nonexistent", "--prompts_path", "/nonexistent.csv",
                 "--save_path", str(root / "out"), "--device", "cpu", "--fleet", a, *extra]))
    with pytest.raises(NotImplementedError, match="item 15"):
        _run(root, "--dp", "2")
    with pytest.raises(SystemExit):
        _run(root, "--compose", f"{a}:1", "--model_name", a)
    with pytest.raises(SystemExit):
        _run(root, "--compose", a)


NAMES = [
    "models/age_alpha1.0_rank4_noxattn/age_alpha1.0_rank4_noxattn_last.pt",
    "out/x/eyes_alpha1.0_rank8_noxattn-hspace-last_200steps.safetensors",
    "models/ballast_xattn/w.pt",
    "fullface_rank2/slider.safetensors",
    "a/b/c.pt",
    "runs/smile_alpha2.5_rank16_selfattn_last.safetensors",
    "models/hspace_last/foo.pt",
    "x/run_xattn-strict_last.pt",
    "x/noxattn_hspace_rankx_alphay/ckpt.pt",
    "person_full_3steps.safetensors",
]


@pytest.mark.parametrize("name", NAMES)
def test_infer_params_from_name_matches_jax(name):
    assert tgen.infer_params_from_name(name) == jgen.infer_params_from_name(name)


@pytest.mark.parametrize("method", ["noxattn", "noxattn-hspace", "xattn-last", None])
def test_infer_scales_matches_jax(tmp_path, method):
    """From the metadata sidecar when there is one, else from the name."""
    ckpt = tmp_path / "age_alpha1.0_rank4_noxattn-hspace_last.safetensors"
    if method is not None:
        (tmp_path / "age_alpha1.0_rank4_noxattn-hspace_metadata.json").write_text(
            json.dumps({"config": {"network": {"training_method": method}}}))
    assert tgen._infer_scales(str(ckpt)) == jgen._infer_scales(str(ckpt))


@pytest.mark.parametrize("scale,name", [
    (0.0, "0"), (1.0, "1"), (-1.0, "-1"), (2.0, "2"), (-2.0, "-2"), (0.5, "half"),
    (-0.5, "-half"), (10.5, "1half"), (1.5, "1.5"), (5.0, "5"), (-5.0, "-5"), (10.0, "10"),
    (0.25, "0.25"), (2.05, "2.05"), (3, "3"),
])
def test_scale_folder_name(scale, name):
    assert tgen.scale_folder_name(scale) == name


def test_read_prompts_csv_matches_pandas(tmp_path):
    """Quotes, a comma inside a prompt, an empty prompt and 'None' (NaN ->
    'nan'), a blank line, float seeds and a leading space, as the JAX CLI
    reads them through pandas."""
    path = tmp_path / "p.csv"
    path.write_text(CSV)
    df = pd.read_csv(path)
    want = [(int(r.case_number), str(r.prompt), int(r.evaluation_seed)) for _, r in df.iterrows()]
    assert tgen.read_prompts_csv(str(path)) == want
    assert [p for _, p, _ in want][1] == "nan" and want[0][2] == 11
    assert tgen.PANDAS_NA == set(pd._libs.parsers.STR_NA_VALUES)


def test_committed_reference_fixture_loads():
    """tests/fixtures/reference_slider_tiny.pt (a reference-format .pt) loads
    through the port's load_slider equal to the JAX load_slider's tree."""
    fix = os.path.join(REPO, "tests", "fixtures", "reference_slider_tiny.pt")
    jtree = jio.load_slider(fix, junet.init_params(jax.random.key(0), junet.TINY))
    ttree = tio.load_slider(fix, tunet.init_params(None, tunet.TINY, device="meta"))
    want = from_jax_params(jax.tree.map(np.asarray, jtree))
    assert set(ttree) == set(want) and len(want) > 0
    for m, e in want.items():
        for k in ("down", "up", "alpha"):
            assert ttree[m][k].dtype == torch.float32
            torch.testing.assert_close(ttree[m][k], e[k], rtol=0, atol=0)


def test_generate_without_jax(root, tmp_path):
    """generate_images (SD, and --xl with euler_a and no CFG), the SD1 and
    Turbo examples' scalar merged path, an import of the FLUX example,
    `serve --continuous` answering a request over HTTP, the real-image
    editing and attention-map examples end to end, a two-slider
    `train_fleet` run and `generate_images --fleet`, with jax, the JAX
    package, pandas and PIL unimportable."""
    xl = make_tiny_snapshot(str(tmp_path / "sdxl_tiny"), xl=True)
    for name in ("a", "b"):
        (tmp_path / f"{name}.yaml").write_text(
            f"- target: person\n  positive: {name} person\n  unconditional: ''\n"
            "  neutral: person\n  resolution: 64\n")
    (tmp_path / "fleet.yaml").write_text(
        f"prompts_file: {tmp_path / 'a.yaml'}\n"
        f"pretrained_model:\n  name_or_path: {root / 'sd_tiny'}\n"
        "network:\n  rank: 2\n  training_method: noxattn\n"
        "train:\n  precision: float32\n  iterations: 2\n  max_denoising_steps: 3\n"
        f"save:\n  name: f\n  path: {tmp_path / 'fleet'}\n"
        "tpu:\n  remat: false\n")
    code = f"""
import argparse, importlib.util, os, sys
banned = ("jax", "flax", "optax", "pydantic", "yaml", "safetensors", "PIL", "pandas",
          "sliders_tpu")
for name in [m for m in sys.modules if m.split(".")[0] in banned]:
    del sys.modules[name]
for name in banned:
    sys.modules[name] = None
import torch
torch.set_num_threads(1)  # tiny tensors; the other test workers share the CPU
from sliders_tpu_torch.cli import generate_images as g
from sliders_tpu_torch.models import loader
base = ["--prompts_path", {str(root / "prompts.csv")!r}, "--device", "cpu", "--precision",
        "float32", "--image_size", "64", "--ddim_steps", "2", "--till_case", "3"]
out = g.main(g.build_parser().parse_args(base + [
    "--base", {str(root / "sd_tiny")!r}, "--save_path", {str(tmp_path / "sd")!r},
    "--model_name", {str(root / "age_alpha1.0_rank2_noxattn_last.safetensors")!r}]))
assert [c for c, _ in out["cases"]] == [3]
out = g.main(g.build_parser().parse_args(base + [
    "--base", {xl!r}, "--xl", "--save_path", {str(tmp_path / "xl")!r}, "--scheduler",
    "euler_a", "--guidance_scale", "1", "--start_noise", "700", "--scales", "0,1"]))
assert sorted(os.listdir(os.path.join({str(tmp_path / "xl")!r}, "base"))) == ["0", "1", "all"]
examples = {{}}
for name in ("sd1_slider_inference_torch", "sdxl_turbo_slider_torch",
             "flux_slider_inference_torch"):
    spec = importlib.util.spec_from_file_location(name, os.path.join({REPO!r}, "examples",
                                                                     name + ".py"))
    examples[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(examples[name])
from sliders_tpu_torch.lora import io as lio
sd = loader.load_sd({str(root / "sd_tiny")!r}, dtype=torch.float32, load_vae=True)
w = lio.load_slider({str(root / "age_alpha1.0_rank2_noxattn_last.safetensors")!r},
                    sd.unet_params)
lats = examples["sd1_slider_inference_torch"].sweep_latents(
    sd, w, "a person", [0.0, 2.0], steps=2, size=64, dtype=torch.float32)
assert len(lats) == 2 and not torch.equal(lats[0], lats[1])
xm = loader.load_sdxl({xl!r}, dtype=torch.float32, load_vae=True)
lats = examples["sdxl_turbo_slider_torch"].sweep_latents(xm, None, "a person", [0.0], steps=3,
                                                         size=64, dtype=torch.float32)
assert torch.isfinite(lats[0]).all()
import json, threading, urllib.request
from sliders_tpu_torch.cli import serve
from sliders_tpu_torch.serving.server import encode_png, make_http_server
engine = serve.make_engine(serve.build_parser().parse_args(
    ["--base", {str(root / "sd_tiny")!r}, "--device", "cpu", "--precision", "float32",
     "--ddim_steps", "2", "--image_size", "64", "--continuous", "--cont_rows", "2",
     "--chunk_steps", "1", "--no_warmup"]))
server = make_http_server(engine, "127.0.0.1", 0)
threading.Thread(target=server.serve_forever, daemon=True).start()
req = urllib.request.Request(f"http://127.0.0.1:{{server.server_address[1]}}/generate",
                             data=json.dumps({{"prompt": "a person", "scales": [0.0, 1.0]}}).encode())
reply = json.loads(urllib.request.urlopen(req, timeout=120).read())
assert len(reply["images"]) == 2 and engine.stats["chunks"] == 2, (reply, engine.stats)
server.shutdown()
engine.close(timeout=60)
for name in ("edit_real_image_torch", "attention_maps_torch"):
    spec = importlib.util.spec_from_file_location(name, os.path.join({REPO!r}, "examples",
                                                                     name + ".py"))
    examples[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(examples[name])
import numpy as np
image = os.path.join({str(tmp_path)!r}, "face.png")
with open(image, "wb") as f:
    f.write(encode_png(np.random.default_rng(0).integers(0, 256, (40, 36, 3), dtype=np.uint8)))
examples["edit_real_image_torch"].main(argparse.Namespace(
    base={str(root / "sd_tiny")!r}, image=image, prompt="a person", slider=None, scales="0,2", steps=2,
    start_noise=500, guidance=7.5, inner_steps=1, size=32, device="cpu",
    out=os.path.join({str(tmp_path)!r}, "edit.png")))
examples["attention_maps_torch"].main(argparse.Namespace(
    base={str(root / "sd_tiny")!r}, prompt="a person", slider=None, scale=1.0, t=501, size=64, res=8, seed=0,
    device="cpu", out=os.path.join({str(tmp_path)!r}, "maps")))
from sliders_tpu_torch.cli import train_fleet
loras = train_fleet.main(train_fleet.build_parser().parse_args(
    ["--config_file", os.path.join({str(tmp_path)!r}, "fleet.yaml"), "--device", "cpu",
     "--prompts_file", os.path.join({str(tmp_path)!r}, "a.yaml"),
     os.path.join({str(tmp_path)!r}, "b.yaml")]))
assert len(loras) == 2
out = g.main(g.build_parser().parse_args(base + [
    "--base", {str(root / "sd_tiny")!r}, "--save_path", {str(tmp_path / "gf")!r},
    "--scales", "0,1", "--fleet", {str(root / "age_alpha1.0_rank2_noxattn_last.safetensors")!r},
    "--fleet", {str(root / "eyes_alpha1.0_rank3_noxattn_last.safetensors")!r}]))
assert len(out["folders"]) == 2
loaded = [k for k, v in sys.modules.items() if v is not None and k.split(".")[0] in banned]
assert not loaded, loaded
print("ok")
"""
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
    for sub in ("-2", "2", "all"):
        assert os.listdir(tmp_path / "sd" / "age_alpha1.0_rank2_noxattn_last" / sub) == \
            ["3_0.png"]
    assert Image.open(io.BytesIO((tmp_path / "xl" / "base" / "all" / "3_0.png").read_bytes())) \
        .size == (2 * 16, 16)
    assert Image.open(tmp_path / "edit.png").size == (2 * 32, 32)
    # bos, eos and the tiny vocabulary's four tokens of "a person"
    assert len(os.listdir(tmp_path / "maps")) == 6
    run = "f_alpha1.0_rank2_noxattn"
    assert sorted(os.listdir(tmp_path / "fleet" / f"{run}_fleet")) == sorted(
        [f"{n}_alpha1.0_rank2_noxattn_last.safetensors" for n in ("a", "b")]
        + [f"{run}_fleet_metadata.json"])
    for stem in ("age_alpha1.0_rank2_noxattn_last", "eyes_alpha1.0_rank3_noxattn_last"):
        assert os.listdir(tmp_path / "gf" / stem / "1") == ["3_0.png"]
