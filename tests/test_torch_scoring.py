"""The port's scale-sweep scorers (evals/scoring.py) against sliders_tpu's
on the CPU, on one run folder: scale folders -1, 0, 1 and half (-> 0.5),
an all/ grid folder, a .csv, a file name whose case does not parse and a
case that is not in the prompts CSV. The CSV has
a quoted prompt with a comma, a float column with an empty cell and an
integer seed. The port's `clip_scores.csv` / `lpips_score.csv` against
what pandas wrote for the JAX scorers: the header and the integer cells
equal as text, the floats within 2e-5 relative, the empty cells in the
same places; and the returned tables against the DataFrames. The CLIP
model is a tiny snapshot both packages load; LPIPS is full-width AlexNet
on the same weights (`from_jax_params`)."""

import csv
import math
import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from helpers import make_tokenizer_files
from PIL import Image

from sliders_tpu.evals import lpips as jlpips
from sliders_tpu.evals import scoring as jscoring
from sliders_tpu.models import clip_vision as jcv
from sliders_tpu_torch.evals import scoring
from sliders_tpu_torch.models import clip_text, clip_vision
from sliders_tpu_torch.models.convert import from_jax_params

REL = 2e-5
CSV = ('case_number,prompt,evaluation_seed,weight\n'
       '0,"an old person, smiling",11,0.5\n'
       '1,a car,12,\n'
       '3,a cat,13,2.25\n')


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("scoring")
    rng = np.random.default_rng(0)
    for folder in ("-1", "0", "1", "half", "all"):
        os.makedirs(root / "run" / folder)
        for name in ("0_0.png", "0_1.png", "1_0.png", "9_0.png", "x_0.png", "3_0.png"):
            if folder == "1" and name == "3_0.png":
                continue  # case 3 has no scale-1 image: NaN there
            Image.fromarray(rng.integers(0, 256, (40, 32, 3), dtype=np.uint8)).save(
                root / "run" / folder / name)
    os.remove(root / "run" / "0" / "0_1.png")  # no scale-0 twin: skipped by LPIPS
    (root / "run" / "notes.csv").write_text("a\n1\n")
    (root / "prompts.csv").write_text(CSV)
    snap = root / "clip"
    vocab = make_tokenizer_files(str(snap))
    tcfg = clip_text.ClipTextConfig(vocab_size=len(vocab), hidden_size=24, num_layers=2,
                                    num_heads=2, intermediate_size=48, max_positions=16,
                                    eos_token_id=vocab["<|endoftext|>"])
    clip_vision.save_clip_model(str(snap), clip_vision.init_params(
        torch.Generator().manual_seed(1), clip_vision.TINY_VISION, tcfg, projection_dim=16),
        clip_vision.TINY_VISION, tcfg)
    return root


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _same_csv(port_rows, jax_rows, df, table):
    assert port_rows[0] == jax_rows[0] == list(df.columns) == list(table)
    assert len(port_rows) == len(jax_rows)
    for p_row, j_row in zip(port_rows[1:], jax_rows[1:]):
        for name, p, j in zip(port_rows[0], p_row, j_row):
            if name in ("case_number", "prompt", "evaluation_seed") or j == "":
                assert p == j, (name, p, j)
            else:
                assert p != "" and math.isclose(float(p), float(j), rel_tol=REL), (name, p, j)
    for name in df.columns:
        for v, want in zip(table[name], df[name]):
            if isinstance(want, str):
                assert v == want
            elif math.isnan(want):
                assert math.isnan(v)
            else:
                assert math.isclose(v, want, rel_tol=REL)


def test_clip_scores_match_jax(run):
    d = run / "run"
    jparams, jvcfg, jtcfg, jtok = jcv.load_clip_model(str(run / "clip"))
    df = jscoring.clip_scores(str(d), "an old person", str(run / "prompts.csv"), jparams,
                              jvcfg, jtcfg, jtok)
    jax_rows = _rows(d / "clip_scores.csv")
    params, vcfg, tcfg, tok = clip_vision.load_clip_model(str(run / "clip"))
    table = scoring.clip_scores(str(d), "an old person", str(run / "prompts.csv"), params,
                                vcfg, tcfg, tok)
    port_rows = _rows(d / "clip_scores.csv")
    assert port_rows[0] == ["case_number", "prompt", "evaluation_seed", "weight", "clip_-1",
                            "clip_0", "clip_1", "clip_0.5"]
    assert port_rows[2][3] == "" and port_rows[3][6] == ""  # the NA weight; no 3_0 at scale 1
    _same_csv(port_rows, jax_rows, df, table)


def test_lpips_scores_match_jax(run):
    d = run / "run"
    jp = jax.tree.map(np.asarray, jlpips.init_params(jax.random.key(2)))
    df = jscoring.lpips_scores(str(d), "0", str(run / "prompts.csv"), jp)
    jax_rows = _rows(d / "lpips_score.csv")
    table = scoring.lpips_scores(str(d), "0", str(run / "prompts.csv"), from_jax_params(jp))
    port_rows = _rows(d / "lpips_score.csv")
    assert port_rows[0] == ["case_number", "prompt", "evaluation_seed", "weight", "lpips_-1",
                            "lpips_1", "lpips_0.5"]
    assert port_rows[3][5] == ""  # case 3 has no scale-1 image
    _same_csv(port_rows, jax_rows, df, table)


def test_read_and_write_table_as_pandas(tmp_path):
    """The CSV's columns typed as pandas.read_csv types them and written
    back as DataFrame.to_csv(index=False) writes them, text for text."""
    src = tmp_path / "in.csv"
    src.write_text('case_number,prompt,evaluation_seed,f,mixed\n'
                   '0,"he said ""hi"", twice",11.0,1e3,x\n'
                   '\n'
                   '2,,12,,7\n'
                   '4,NA,13,0.1,\n')
    table = scoring.read_table(str(src))
    scoring.write_table(table, str(tmp_path / "port.csv"))
    pd.read_csv(src).to_csv(tmp_path / "pandas.csv", index=False)
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "pandas.csv").read_text()
    assert scoring.sorted_nicely(["10_0.png", "2_0.png", "1_10.png", "1_2.png"]) == \
        jscoring.sorted_nicely(["10_0.png", "2_0.png", "1_10.png", "1_2.png"])
