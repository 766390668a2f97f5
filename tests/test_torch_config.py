"""The port's config, prompt and YAML loading against sliders_tpu (pydantic
and PyYAML) on every YAML under data/, and the error cases."""

import glob
import json
import os

import pytest
import yaml

from sliders_tpu.core import config as jconfig
from sliders_tpu.prompts import load_prompts_from_yaml as jload_prompts
from sliders_tpu_torch.core import config as tconfig
from sliders_tpu_torch.core import yaml_subset
from sliders_tpu_torch.prompts import load_prompts_from_yaml as tload_prompts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = sorted(glob.glob(os.path.join(REPO, "data", "*.yaml")))
CONFIGS = [p for p in DATA if os.path.basename(p).startswith("config")]
PROMPTS = [p for p in DATA if os.path.basename(p).startswith("prompts")]


def _ids(paths):
    return [os.path.basename(p) for p in paths]


@pytest.mark.parametrize("path", DATA, ids=_ids(DATA))
def test_yaml_subset_reads_data_like_pyyaml(path):
    with open(path) as f:
        assert yaml_subset.load(path) == yaml.safe_load(f)


@pytest.mark.parametrize(
    "text",
    [
        "a: 1\nb:\n  - x\n  - y\nc:\n- p\n- q\n",  # a key's sequence at the key's indentation
        "- key:\n  - a\n  - b\n- k2: v\n  k3: 'it''s'\n",
        'x: "a # b"  # comment\ny: -.5\nz: 1e-4\nw: 1_000\nv: .5\nu: +3\nt: 1.\n',
        "s: -1.5e+3\nt: yes\nn: ~\nf: Off\ne:\nq: \"tab\\tand \\\"quote\\\"\"\n",
        "a: b\n  c\n  d\n",  # folded plain scalar
        "[]",
        "",
        "# only a comment\n",
    ],
)
def test_yaml_subset_scalars_like_pyyaml(text):
    assert yaml_subset.loads(text) == yaml.safe_load(text)


@pytest.mark.parametrize(
    "text",
    ["a: &x 1", "a: *x", "a: !!str 1", "a: |\n  x", "a: [1, 2]", "a: {b: 1}", "a: 0x1f",
     "a: 012", "---\na: 1", "a: 1\na: 2"],
)
def test_yaml_subset_refuses_the_rest(text):
    with pytest.raises(yaml_subset.YamlSubsetError, match="line"):
        yaml_subset.loads(text)


@pytest.mark.parametrize("path", CONFIGS, ids=_ids(CONFIGS))
def test_config_matches_jax(path):
    ref = json.loads(jconfig.load_config_from_yaml(path).model_dump_json())
    out = tconfig.to_dict(tconfig.load_config_from_yaml(path))
    assert out == ref
    assert list(out) == list(ref)  # the metadata sidecar keeps the field order


@pytest.mark.parametrize("attributes", [[], ["male", "female"]], ids=["plain", "attributes"])
@pytest.mark.parametrize("path", PROMPTS, ids=_ids(PROMPTS))
def test_prompts_match_jax(path, attributes):
    ref = [p.model_dump() for p in jload_prompts(path, attributes)]
    out = [p.to_dict() for p in tload_prompts(path, attributes)]
    assert out == ref and len(out) > 0


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def test_null_sections_and_coercion_match_jax(tmp_path):
    """A section with no body takes its defaults; numbers written as YAML
    strings (`2e-4`) and ints as floats coerce as pydantic coerces them."""
    path = _write(tmp_path, "c.yaml",
                  "prompts_file: p.yaml\npretrained_model:\n  name_or_path: m\n  clip_skip: 2.0\n"
                  "train:\n  lr: 2e-4\n  iterations: '30'\nsave:\nlogging:\n  verbose: 1\n"
                  "tpu:\n  remat: off\n  unknown_knob: 3\n")
    ref = json.loads(jconfig.load_config_from_yaml(path).model_dump_json())
    out = tconfig.to_dict(tconfig.load_config_from_yaml(path))
    assert out == ref
    assert out["train"]["lr"] == 2e-4 and out["save"]["per_steps"] == 200


@pytest.mark.parametrize(
    "text",
    [
        "prompts_file: p\npretrained_model:\n  name_or_path: m\nnetwork:\n  training_method: bogus\n",
        "prompts_file: p\npretrained_model:\n  name_or_path: m\ntrain:\n  precision: fp8\n",
        "prompts_file: p\npretrained_model:\n  name_or_path: m\ntrain:\n  iterations: many\n",
        "prompts_file: p\npretrained_model:\n",
        "prompts_file: p\n",
    ],
    ids=["training_method", "precision", "iterations", "null_model", "no_model"],
)
def test_bad_config_raises_like_jax(tmp_path, text):
    path = _write(tmp_path, "bad.yaml", text)
    with pytest.raises(ValueError):
        jconfig.load_config_from_yaml(path)
    with pytest.raises(ValueError):
        tconfig.load_config_from_yaml(path)


def test_bad_training_method_names_the_choices(tmp_path):
    path = _write(tmp_path, "bad.yaml", "prompts_file: p\npretrained_model:\n  name_or_path: m\n"
                  "network:\n  training_method: bogus\n")
    with pytest.raises(ValueError, match="'noxattn'.*'xattn-mid'"):
        tconfig.load_config_from_yaml(path)


def test_empty_prompts_file_raises_like_jax(tmp_path):
    path = _write(tmp_path, "p.yaml", "[]\n")
    with pytest.raises(ValueError, match="prompts file is empty"):
        jload_prompts(path)
    with pytest.raises(ValueError, match="prompts file is empty"):
        tload_prompts(path)


def test_prompt_without_target_raises_like_jax(tmp_path):
    path = _write(tmp_path, "p.yaml", "- positive: old\n")
    with pytest.raises(ValueError, match="target must be specified"):
        jload_prompts(path)
    with pytest.raises(ValueError, match="target must be specified"):
        tload_prompts(path)
