"""LLM-assisted slider prompt authoring (port of
sliders_tpu/tools/prompt_helper.py).

Reproduces the GPT_prompt_helper.ipynb flow (cells 2-3): ask an LLM to
produce Target / Positive / Negative / Preservation / Name lines for a
slider described in natural language, parse them, Cartesian-expand the
preservation attribute classes, and write a training prompts YAML with the
notebook's defaults (guidance 4, rank 4, enhance, 512px).

The LLM is pluggable: pass any `llm(system_prompt, user_query) -> str`
callable (an OpenAI client adapter is provided for parity; it needs the
openai package and the network, so tests inject a fake).

The JAX package writes the file with PyYAML's `safe_dump(..., sort_keys=False)`;
the port writes the same block list itself (`dump_entries`), every string
double-quoted, so PyYAML and the port's `core/yaml_subset.py` read it back
to the same entries.
"""

from __future__ import annotations

import json
from typing import Callable, Optional

SYSTEM_PROMPT = """You are an expert in prompting text-image generation models. Given a concept to edit, your task is to generate 4 detailed prompts.
1. Target prompt: a prompt that describes the target class which the concept edit is intended to modify. Leave it empty if the target concept is too large (e.g. a global style edit applies to every image).
2. Positive prompt: a detailed prompt that describes the extreme positive end of the edit concept with the target concept included.
3. Negative prompt: a detailed prompt that describes the extreme negative end of the edit concept with the target concept included. Leave it empty if there is no obvious negative.
4. Preservation prompt: comma separated concepts that must be preserved while editing (attribute classes separated by ';', e.g. "white race, black race, asian race; male, female"). Leave empty if nothing is obviously entangled.

All prompts must be plain strings without alphanumeric symbols. Respond exactly in this template:
Target: <...>
Positive: <...>
Negative: <...>
Preservation: <...>
Name: <short_snake_case_name>_GPT
"""


def parse_llm_response(content: str) -> tuple[dict, list[list[str]], Optional[str]]:
    """-> (prompt dict, preservation attribute classes, name)."""
    result = {"target": "", "positive": "", "unconditional": "", "neutral": ""}
    attribute_classes: list[list[str]] = []
    name = None
    for line in content.splitlines():
        parts = line.split(":", 1)
        if len(parts) != 2:
            continue
        key, value = parts[0].lower().strip(), parts[1].strip()
        if key == "target":
            result["target"] = value
        elif key == "positive":
            result["positive"] = value
        elif key == "negative":
            result["unconditional"] = value
        elif key == "preservation":
            for cls_ in value.split(";"):
                attrs = [a.strip() for a in cls_.split(",") if a.strip()]
                if attrs:
                    attribute_classes.append(attrs)
        elif key == "name":
            name = value
    result["neutral"] = result["target"]
    return result, attribute_classes, name


def expand_preservation(result: dict, attribute_classes: list[list[str]]) -> list[dict]:
    """Cartesian product over attribute classes, each attribute prepended to
    every prompt (notebook cell 3 expansion)."""
    results = [result]
    for attrs in attribute_classes:
        expanded = []
        for attr in attrs:
            for r in results:
                expanded.append({k: f"{attr} {v}".strip() for k, v in r.items()})
        results = expanded
    return results


def _yaml_scalar(value) -> str:
    """One entry value as a YAML scalar both readers resolve to `value`:
    true / false, a decimal int, or a double-quoted string."""
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if not isinstance(value, str):
        raise TypeError(f"prompt entries hold strings, ints and bools, not {value!r}")
    if any(ord(c) < 32 and c not in "\t\n\r" for c in value) or "\x7f" in value:
        raise ValueError(f"control character in {value!r}")
    # the escapes both readers take: backslash, quote, tab, newline, return
    return json.dumps(value, ensure_ascii=False)


def dump_entries(entries: list[dict]) -> str:
    """A list of flat mappings as a YAML block sequence, keys in order (what
    `yaml.safe_dump(entries, sort_keys=False)` writes, quoting aside)."""
    lines = []
    for entry in entries:
        for i, (k, v) in enumerate(entry.items()):
            lines.append(f"{'- ' if i == 0 else '  '}{k}: {_yaml_scalar(v)}")
    return "\n".join(lines) + "\n"


def generate_prompts_sliders(
    slider_query: str,
    llm: Optional[Callable[[str, str], str]] = None,
    file_name_to_save: Optional[str] = None,
    save: bool = True,
    verbose: bool = False,
) -> tuple[list[dict], Optional[str]]:
    """Returns (prompt entries, saved path). Entries carry the notebook's
    training defaults and load directly via
    prompts.settings.load_prompts_from_yaml."""
    if llm is None:
        llm = openai_llm()
    content = llm(SYSTEM_PROMPT, slider_query)
    if verbose:
        print(content)
    result, attribute_classes, name = parse_llm_response(content)
    entries = []
    for r in expand_preservation(result, attribute_classes):
        entries.append(
            {
                **r,
                "guidance": 4,
                "rank": 4,
                "action": "enhance",
                "resolution": 512,
                "dynamic_resolution": False,
                "batch_size": 1,
            }
        )
    path = None
    if save:
        path = file_name_to_save or (f"{name}.yaml" if name else "custom-prompts-GPT.yaml")
        with open(path, "w", encoding="utf-8") as f:
            f.write(dump_entries(entries))
    return entries, path


def openai_llm(model: str = "gpt-4-turbo-preview", temperature: float = 0.2, max_tokens: int = 256):
    """OpenAI-client adapter (requires the openai package + network)."""
    try:
        from openai import OpenAI
    except ImportError as e:
        raise RuntimeError(
            "openai package unavailable; pass a custom llm callable"
        ) from e
    client = OpenAI()

    def call(system_prompt: str, user_query: str) -> str:
        resp = client.chat.completions.create(
            model=model,
            messages=[
                {"role": "assistant", "content": system_prompt},
                {"role": "user", "content": user_query},
            ],
            temperature=temperature,
            max_tokens=max_tokens,
        )
        return resp.choices[0].message.content

    return call
