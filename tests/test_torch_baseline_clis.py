"""The port's five eval CLIs end to end with `--device cpu` on tiny SD and
SDXL snapshots (2 steps): `generate_images_uce`, `generate_images_text_
inversion` (SD with a token it must add, and `--xl` with an {'emb','emb2'}
pair), `generate_images_custom_diffusion` (`--compress`), then
`clip_score` and `lpips_score` on the UCE run folder. The folders and
files each writes are the JAX CLI's on the same inputs (the JAX CLIs run
with their denoise loops and VAE decodes replaced by stand-ins: only their
layouts are compared; the numbers are held in test_torch_baselines.py and
test_torch_scoring.py). Then the scorers and the UCE generator in a
process where jax, the JAX package, pandas, PIL and transformers cannot be
imported (the card's machine has none of them)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from helpers import make_tokenizer_files
from torch_tiny_snapshot import write_tiny_snapshot

from sliders_tpu_torch.cli import clip_score, generate_images_custom_diffusion
from sliders_tpu_torch.cli import generate_images_text_inversion, generate_images_uce
from sliders_tpu_torch.cli import lpips_score
from sliders_tpu_torch.evals import lpips
from sliders_tpu_torch.models import clip_text, clip_vision, unet2d
from sliders_tpu_torch.utils.pytree import flatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = "text_model.embeddings.token_embedding.weight"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tmp_path_factory.mktemp("baseline_clis")
    write_tiny_snapshot(r / "sd")
    write_tiny_snapshot(r / "sdxl", xl=True)
    (r / "prompts.csv").write_text("case_number,prompt,evaluation_seed\n0,car,42\n7,sun,7\n")
    return r


def _layout(top) -> dict:
    """{relative folder: sorted file names} under `top`."""
    return {os.path.relpath(d, top): sorted(files) for d, _, files in os.walk(top)}


@pytest.fixture
def jax_cli(monkeypatch):
    """Run a JAX CLI's main with its denoise loop (the latents returned as
    they came) and its VAE decode (zeros of the tiny VAE's 2x size) stood in
    for: its loading, prompt handling, folders and file names are its own."""
    import jax.numpy as jnp

    from sliders_tpu.evals import baselines as jb
    from sliders_tpu.pipelines import text2image as jt2i

    monkeypatch.setattr(jb, "make_uce_sampling_fn", lambda *a, **k: lambda o, e, x, *r: x)
    monkeypatch.setattr(jt2i, "make_sampling_fn", lambda *a, **k: lambda p, x, *r: x)
    monkeypatch.setattr(jt2i, "decode_images", lambda p, c, x: jnp.zeros(
        (x.shape[0], 2 * x.shape[1], 2 * x.shape[2], 3), jnp.uint8))

    def run(module, argv):
        module.main(module.build_parser().parse_args(argv))

    return run


def _port(module, argv):
    return module.main(module.build_parser().parse_args(argv + ["--device", "cpu"]))


COMMON = ["--image_size", "64", "--ddim_steps", "2", "--precision", "float32"]


def test_uce_cli_layout_and_scales(root, tmp_path, jax_cli):
    from sliders_tpu.cli import generate_images_uce as juce

    state = {k: v + 0.05 for k, v in flatten(unet2d.init_params(
        torch.Generator().manual_seed(21), unet2d.TINY)).items()}
    torch.save(state, tmp_path / "uce_age.pt")
    argv = ["--model_name", str(tmp_path / "uce_age.pt"), "--prompts_path",
            str(root / "prompts.csv"), "--base", str(root / "sd"), "--num_samples", "2",
            "--scales=-1,0,0.5", "--till_case", "5", *COMMON]
    out = _port(generate_images_uce, argv + ["--save_path", str(tmp_path / "port")])
    jax_cli(juce, argv + ["--save_path", str(tmp_path / "jax")])
    assert _layout(tmp_path / "port") == _layout(tmp_path / "jax")
    folder = tmp_path / "port" / "uce_age"
    assert out["folder"] == str(folder) and [c for c, _ in out["cases"]] == [0]
    assert sorted(os.listdir(folder)) == ["-1", "0", "all", "half"]
    from sliders_tpu_torch.data.native_loader import decode_file

    imgs = {s: decode_file(str(folder / s / "0_0.png")) for s in ("-1", "0", "half")}
    assert len({im.tobytes() for im in imgs.values()}) == 3  # the scale moves the image
    np.testing.assert_array_equal(decode_file(str(folder / "all" / "0_0.png")),
                                  np.concatenate([imgs[s] for s in ("-1", "0", "half")], 1))
    assert not np.array_equal(imgs["0"], decode_file(str(folder / "0" / "0_1.png")))


@pytest.mark.parametrize("xl", [False, True])
def test_text_inversion_cli(root, tmp_path, jax_cli, xl):
    """SD: a {token: vector} file for '<sks-style>', which the tiny
    vocabulary cannot spell, so the tokenizer adds it and the matrix grows;
    XL: an {'emb','emb2'} pair for 'sks' (three pieces: added to both).
    The encoders' new rows equal the file's vectors."""
    from sliders_tpu.cli import generate_images_text_inversion as jti

    token = "sks" if xl else "<sks-style>"
    vecs = [torch.randn(16 if xl else 32, generator=torch.Generator().manual_seed(i))
            for i in range(2)]
    emb = {"emb": vecs[0], "emb2": vecs[1]} if xl else {token: vecs[0]}
    torch.save(emb, tmp_path / "learned.pt")
    argv = ["--model_name", str(root / ("sdxl" if xl else "sd")), "--prompts_path",
            str(root / "prompts.csv"), "--token", token, "--embedding_file",
            str(tmp_path / "learned.pt"), "--num_samples", "2", *COMMON,
            *(["--xl", "--suffix", " with {token} eyes"] if xl else [])]
    out = _port(generate_images_text_inversion, argv + ["--save_path", str(tmp_path / "port")])
    jax_cli(jti, argv + ["--save_path", str(tmp_path / "jax")])
    assert _layout(tmp_path / "port") == _layout(tmp_path / "jax") == {
        ".": [], "learned": ["0_0.png", "0_1.png", "7_0.png", "7_1.png"]}
    assert [c for c, _ in out["cases"]] == [0, 7]
    for te, vec in zip(out["text_encoders"], vecs):
        tid = te.tokenizer.convert_tokens_to_ids(token)
        assert tid == len(te.tokenizer) - 1
        assert torch.equal(flatten(te.params)[KEY][tid], vec)


def test_custom_diffusion_cli(root, tmp_path, jax_cli):
    """An SDXL delta checkpoint: attn2 to_k / to_v as {'u','v'} factors
    (`--compress`) and a modifier token with an embedding for each encoder;
    the run is named after the checkpoint's folder."""
    from sliders_tpu.cli import generate_images_custom_diffusion as jcd

    gen = torch.Generator().manual_seed(5)
    unet = flatten(unet2d.init_params(None, unet2d.TINY_XL, device="meta"))
    deltas = {k: {"u": torch.randn(w.shape[0], 2, generator=gen),
                  "v": torch.randn(2, w.shape[1], generator=gen) * 0.1}
              for k, w in unet.items() if "attn2.to_k.weight" in k or "attn2.to_v.weight" in k}
    os.makedirs(tmp_path / "eyebrows_run")
    ckpt = tmp_path / "eyebrows_run" / "delta.pt"
    torch.save({"unet": deltas, "modifier_token": {"<sks-eyebrows>": [
        torch.randn(16, generator=gen), torch.randn(16, generator=gen)]}}, ckpt)
    argv = ["--model_name", str(ckpt), "--prompts_path", str(root / "prompts.csv"),
            "--token", "<sks-eyebrows>", "--base", str(root / "sdxl"), "--compress",
            "--num_samples", "1", *COMMON]
    out = _port(generate_images_custom_diffusion, argv + ["--save_path", str(tmp_path / "port")])
    jax_cli(jcd, argv + ["--save_path", str(tmp_path / "jax")])
    assert _layout(tmp_path / "port") == _layout(tmp_path / "jax") == {
        ".": [], "eyebrows_run": ["0_0.png", "7_0.png"]}
    assert out["folder"] == str(tmp_path / "port" / "eyebrows_run")
    for te in out["text_encoders"]:  # the token added to both, each matrix one row longer
        assert te.tokenizer.convert_tokens_to_ids("<sks-eyebrows>") == len(te.tokenizer) - 1
        assert flatten(te.params)[KEY].shape[0] == len(te.tokenizer)


def _scorer_inputs(root, tmp_path):
    """A UCE run folder (the port's generator), a tiny CLIP snapshot and
    torchvision / lpips .pth files, all from seeds."""
    state = {k: v + 0.05 for k, v in flatten(unet2d.init_params(
        torch.Generator().manual_seed(22), unet2d.TINY)).items()}
    torch.save(state, tmp_path / "uce_smile.pt")
    vocab = make_tokenizer_files(str(tmp_path / "clip"))
    tcfg = clip_text.ClipTextConfig(vocab_size=len(vocab), hidden_size=24, num_layers=2,
                                    num_heads=2, intermediate_size=48, max_positions=16,
                                    eos_token_id=vocab["<|endoftext|>"])
    clip_vision.save_clip_model(str(tmp_path / "clip"), clip_vision.init_params(
        torch.Generator().manual_seed(2), clip_vision.TINY_VISION, tcfg),
        clip_vision.TINY_VISION, tcfg)
    alex, lins = lpips.torchvision_state(lpips.init_params(torch.Generator().manual_seed(3)))
    torch.save(alex, tmp_path / "alexnet.pth")
    torch.save(lins, tmp_path / "alex.pth")


def test_score_clis(root, tmp_path, jax_cli):
    """clip_score and lpips_score on a UCE run folder write the JAX CLIs'
    CSV (same name, header, text cells and empty cells, scores within 2e-5
    of the largest) and nothing else; --true 0 leaves the scale-0 column
    out of the LPIPS table."""
    import csv

    from sliders_tpu.cli import clip_score as jclip
    from sliders_tpu.cli import lpips_score as jlp

    _scorer_inputs(root, tmp_path)
    _port(generate_images_uce, ["--model_name", str(tmp_path / "uce_smile.pt"),
                                "--prompts_path", str(root / "prompts.csv"), "--base",
                                str(root / "sd"), "--num_samples", "1", "--scales=-1,0,1",
                                "--save_path", str(tmp_path / "out"), *COMMON])
    run = str(tmp_path / "out" / "uce_smile")
    clip_argv = ["--im_path", run, "--prompt", "an old person", "--prompts_path",
                 str(root / "prompts.csv"), "--clip_model", str(tmp_path / "clip")]
    lpips_argv = ["--im_path", run, "--prompts_path", str(root / "prompts.csv"), "--true", "0",
                  "--alexnet_weights", str(tmp_path / "alexnet.pth"), "--lpips_weights",
                  str(tmp_path / "alex.pth")]
    tables = {}
    for who, run_cli in (("jax", jax_cli), ("port", lambda m, a: _port(m, a))):
        for module, argv, name in (({"jax": jclip, "port": clip_score}[who], clip_argv,
                                    "clip_scores.csv"),
                                   ({"jax": jlp, "port": lpips_score}[who], lpips_argv,
                                    "lpips_score.csv")):
            run_cli(module, argv)
            with open(os.path.join(run, name), newline="") as f:
                tables[who, name] = list(csv.reader(f))
        assert sorted(f for f in os.listdir(run) if f.endswith(".csv")) == \
            ["clip_scores.csv", "lpips_score.csv"]
    assert tables["port", "clip_scores.csv"][0] == tables["jax", "clip_scores.csv"][0] == [
        "case_number", "prompt", "evaluation_seed", "clip_-1", "clip_0", "clip_1"]
    assert tables["port", "lpips_score.csv"][0] == tables["jax", "lpips_score.csv"][0] == [
        "case_number", "prompt", "evaluation_seed", "lpips_-1", "lpips_1"]
    for name in ("clip_scores.csv", "lpips_score.csv"):
        port_rows, jax_rows = tables["port", name], tables["jax", name]
        assert [r[:3] for r in port_rows] == [r[:3] for r in jax_rows]
        # LPIPS between these near-alike images is ~1e-5: held to 2e-5 of
        # the largest score, not of each
        got, want = (np.array([[float(v or "nan") for v in r[3:]] for r in rows[1:]])
                     for rows in (port_rows, jax_rows))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-5 * float(np.nanmax(np.abs(want))))


def test_scorers_and_uce_without_jax(root, tmp_path):
    """clip_score, lpips_score and generate_images_uce with jax, the JAX
    package, pandas, PIL and transformers unimportable."""
    _scorer_inputs(root, tmp_path)
    code = f"""
import os, sys
banned = ("jax", "flax", "optax", "pydantic", "yaml", "safetensors", "PIL", "pandas",
          "transformers", "sliders_tpu")
for name in [m for m in sys.modules if m.split(".")[0] in banned]:
    del sys.modules[name]
for name in banned:
    sys.modules[name] = None
from sliders_tpu_torch.cli import clip_score, generate_images_uce, lpips_score
def run(m, argv):
    return m.main(m.build_parser().parse_args(argv + ["--device", "cpu"]))
out = run(generate_images_uce, ["--model_name", {str(tmp_path / "uce_smile.pt")!r},
    "--prompts_path", {str(root / "prompts.csv")!r}, "--base", {str(root / "sd")!r},
    "--save_path", {str(tmp_path / "out")!r}, "--num_samples", "1", "--scales=-1,0",
    "--till_case", "5", "--image_size", "64", "--ddim_steps", "2", "--precision", "float32"])
table = run(clip_score, ["--im_path", out["folder"], "--prompt", "an old person",
    "--prompts_path", {str(root / "prompts.csv")!r}, "--clip_model", {str(tmp_path / "clip")!r}])
assert list(table) == ["case_number", "prompt", "evaluation_seed", "clip_-1", "clip_0"], table
table = run(lpips_score, ["--im_path", out["folder"], "--prompts_path",
    {str(root / "prompts.csv")!r}, "--true", "0", "--alexnet_weights",
    {str(tmp_path / "alexnet.pth")!r}, "--lpips_weights", {str(tmp_path / "alex.pth")!r}])
assert table["lpips_-1"][0] > 0 and table["lpips_-1"][1] != table["lpips_-1"][1], table
bad = sorted(m for m in sys.modules if m.split(".")[0] in banned and sys.modules[m] is not None)
assert not bad, bad
print("OK")
"""
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("OK"), res.stderr[-3000:]
