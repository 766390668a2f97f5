"""The port's debug helpers (`utils/debug.py`) and prompt helper
(`tools/prompt_helper.py`) against the JAX package's on the same inputs, on
the CPU: the same summary strings, NaN / Inf paths and parameter counts on
the same trees (JAX numpy leaves, the port's through `from_jax_params`);
the same prompt entries from a fake LLM, and a prompts YAML that PyYAML,
the port's YAML reader and both packages' `load_prompts_from_yaml` read
back alike. Then the runbook (`validate_real_weights --device cpu --ckpt`)
and the prompt helper in a process where jax, the JAX package, PyYAML,
safetensors and PIL cannot be imported (the card's machine has none of
them)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import yaml
from torch_tiny_snapshot import write_tiny_snapshot

from sliders_tpu.prompts.settings import load_prompts_from_yaml as jax_load_prompts
from sliders_tpu.tools import prompt_helper as jph
from sliders_tpu.utils import debug as jdebug
from sliders_tpu_torch.core import yaml_subset
from sliders_tpu_torch.models.convert import from_jax_params
from sliders_tpu_torch.prompts.settings import load_prompts_from_yaml
from sliders_tpu_torch.tools import prompt_helper as tph
from sliders_tpu_torch.utils import debug as tdebug

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LLM_REPLY = """Sure, here it is.
Target: person
Positive: person, smiling: very "happy" # not a comment
Negative:
Preservation: white race, black race; male , female,
Name: smile_slider_GPT
"""


def _slider(rng, stacked: bool = False) -> dict:
    """A JAX-layout slider tree with numpy leaves: linear (in, r) / (r, out)
    and conv (kh, kw, in, r) / (1, 1, r, out) factors, with a leading row
    axis of 2 when stacked."""
    lead = (2,) if stacked else ()
    shapes = {"lora_unet_a_to_q": ((8, 4), (4, 6)), "lora_unet_b_conv1": ((3, 3, 5, 2), (1, 1, 2, 7)),
              "lora_unet_c_proj": ((6, 1), (1, 3))}
    return {name: {"down": rng.standard_normal(lead + d).astype(np.float32),
                   "up": rng.standard_normal(lead + u).astype(np.float32),
                   "alpha": np.float32(0.5 * (i + 1))}
            for i, (name, (d, u)) in enumerate(shapes.items())}


@pytest.mark.parametrize("stacked", [False, True], ids=["solo", "stacked"])
def test_debug_helpers_match_jax(stacked):
    rng = np.random.default_rng(0)
    lora = _slider(rng, stacked)
    port = from_jax_params(lora)
    for max_modules in (5, 2):
        assert tdebug.describe_network(port, max_modules) == \
            jdebug.describe_network(lora, max_modules)
    model = {"down_blocks": {"0": {"conv": {"weight": rng.standard_normal((3, 3, 4, 8)),
                                            "bias": rng.standard_normal(8)}}},
             "proj": {"weight": rng.standard_normal((8, 5)), "bias": rng.standard_normal(5)},
             "norm": {"weight": np.ones(5)}}
    model["down_blocks"]["0"]["conv"]["weight"][1, 2, 3, 4] = np.nan
    model["proj"]["bias"][0] = -np.inf
    tmodel = from_jax_params(model)
    assert tdebug.find_nonfinite(tmodel) == jdebug.find_nonfinite(model) == [
        "down_blocks.0.conv.weight", "proj.bias"]
    assert tdebug.find_nonfinite(port) == jdebug.find_nonfinite(lora) == []
    assert tdebug.param_count(tmodel) == jdebug.param_count(model) == 288 + 8 + 40 + 5 + 5
    assert tdebug.param_count(port) == jdebug.param_count(lora)


def test_prompt_helper_matches_jax_and_round_trips(tmp_path, monkeypatch):
    """A fake LLM's reply -> JAX's entries; the port's YAML reads back to
    them under PyYAML and the port's reader, and both packages' prompt
    loaders give the same settings from the two packages' files."""
    assert tph.SYSTEM_PROMPT == jph.SYSTEM_PROMPT
    assert tph.parse_llm_response(LLM_REPLY) == jph.parse_llm_response(LLM_REPLY)
    calls = []

    def llm(system, query):
        calls.append((system, query))
        return LLM_REPLY

    monkeypatch.chdir(tmp_path)  # the default save path is the current directory
    entries, path = tph.generate_prompts_sliders("a smile slider", llm=llm)
    jentries, jpath = jph.generate_prompts_sliders("a smile slider", llm=llm,
                                                    file_name_to_save=str(tmp_path / "jax.yaml"))
    assert entries == jentries and len(entries) == 4
    assert calls == [(jph.SYSTEM_PROMPT, "a smile slider")] * 2
    assert path == "smile_slider_GPT.yaml" and os.path.exists(tmp_path / path)
    assert entries[0]["target"] == "male white race person"
    assert entries[0]["unconditional"] == "male white race"
    with open(path) as f:
        assert yaml.safe_load(f) == entries
    assert yaml_subset.load(path) == entries
    port_settings = [p.to_dict() for p in load_prompts_from_yaml(path)]
    assert port_settings == [p.model_dump() for p in jax_load_prompts(jpath)]
    assert port_settings[1]["guidance_scale"] == 4.0 and port_settings[1]["action"] == "enhance"

    _, unnamed = tph.generate_prompts_sliders("x", llm=lambda s, q: "Target: car\n")
    assert unnamed == "custom-prompts-GPT.yaml"
    entries, none = tph.generate_prompts_sliders("x", llm=lambda s, q: "Target: car\n",
                                                 save=False)
    assert none is None and entries == jph.generate_prompts_sliders(
        "x", llm=lambda s, q: "Target: car\n", save=False)[0]
    with pytest.raises(ValueError, match="control character"):
        tph.dump_entries([{"target": "a\x07b"}])


def test_runbook_and_prompt_helper_without_jax(tmp_path):
    """`validate_real_weights --device cpu --ckpt` (2 steps at 64 px, the
    single file's configs patched to the tiny ones) and the prompt helper,
    with jax, flax, optax, pydantic, PyYAML, safetensors, PIL and the JAX
    package unimportable."""
    snap = write_tiny_snapshot(tmp_path / "sd")
    code = f"""
import os, sys
banned = ("jax", "flax", "optax", "pydantic", "yaml", "safetensors", "PIL", "sliders_tpu")
for name in [m for m in sys.modules if m.split(".")[0] in banned]:
    del sys.modules[name]
for name in banned:
    sys.modules[name] = None
import json
from unittest import mock
import torch
torch.set_num_threads(1)  # tiny tensors; beside the other test workers a pool oversubscribes
from sliders_tpu_torch.cli import validate_real_weights as rb
from sliders_tpu_torch.models import clip_text, convert, loader, unet2d, vae
from sliders_tpu_torch.models import ldm_checkpoint as ldm
from sliders_tpu_torch.prompts.settings import load_prompts_from_yaml
from sliders_tpu_torch.tools import prompt_helper
snap = {snap!r}
convert.write_safetensors("sd.safetensors", ldm.to_ldm_state(
    convert.load_component(snap, "unet"), unet2d.TINY, convert.load_component(snap, "vae"),
    vae.TINY, convert.load_component(snap, "text_encoder")))
te = loader.clip_config_from_hf(convert.load_component_config(snap, "text_encoder"))
with mock.patch.object(unet2d, "SD15", unet2d.TINY), mock.patch.object(vae, "SD_VAE", vae.TINY), \\
        mock.patch.object(clip_text, "CLIP_L", te):
    rc = rb.main(rb.build_parser().parse_args(["--sd15", snap, "--ckpt", "sd.safetensors",
        "--golden", "g.npz", "--out", "out", "--steps", "2", "--image_size", "64",
        "--device", "cpu"]))
status = {{k: v["status"] for k, v in json.load(open("out/validation.json")).items()}}
assert rc == 0 and status == {{"load": "PASS", "eps_golden": "RECORDED", "single_file": "PASS",
    "clip": "SKIP", "lpips": "SKIP", "sweep": "PASS"}}, status
entries, path = prompt_helper.generate_prompts_sliders("x", llm=lambda s, q: {LLM_REPLY!r})
assert [p.target for p in load_prompts_from_yaml(path)] == [e["target"] for e in entries]
bad = sorted(m for m in sys.modules if m.split(".")[0] in banned and sys.modules[m] is not None)
assert not bad, bad
print("OK")
"""
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("OK"), res.stderr[-3000:]
