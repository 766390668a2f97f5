"""Scale-sweep quality scoring (port of sliders_tpu/evals/scoring.py; the
reference eval harness, SURVEY.md §2.4).

Directory contract (generate_images_sd1.py:113-121 + clip_score.py:33-75 +
lpip_score.py:47-76): a run folder contains one subfolder per slider scale
('-2', '-1', '0', '1', '2', 'half' for 0.5, plus 'all' for grids) with
images named `{case_number}_{i}.png`; scorers read the prompt CSV
(case_number, prompt, evaluation_seed, ...) and write `clip_scores.csv` /
`lpips_score.csv` with one column per scale.

No pandas and no PIL (the card's machine has neither): the CSV is read
column by column as pandas.read_csv types it (`read_table`) and written as
`DataFrame.to_csv(index=False)` writes it (`write_table`); PNGs are decoded
by `data/native_loader.decode_file`. Both scorers run in f32 with cuDNN's
and cuBLAS's TF32 off, so a score on the card is the CPU's up to the order
of its sums. The reference's quirks are kept: a file's case is
`int(name.split("_")[0].replace(".png", ""))` and names that do not parse
are skipped, cases not in the CSV are ignored, clip columns start at NaN
and lpips columns at 0.0, LPIPS matches files by the `{case}_` prefix and
skips a file with no scale-0 twin.
"""

from __future__ import annotations

import csv
import math
import os
import re

import numpy as np
import torch

from sliders_tpu_torch.ops.basic import tf32_flags


def sorted_nicely(items):
    convert = lambda t: int(t) if t.isdigit() else t  # noqa: E731
    return sorted(items, key=lambda k: [convert(c) for c in re.split(r"([0-9]+)", k)])


def _scale_folders(path: str, exclude=()):
    names = [
        m
        for m in os.listdir(path)
        if "all" not in m and ".csv" not in m and m not in exclude
        and os.path.isdir(os.path.join(path, m))
    ]
    return sorted(names)


# pandas.read_csv's default NA strings: such a cell is NaN, which
# str(row.prompt) turns into "nan"
PANDAS_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
             "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}


def _typed(cells: list) -> list:
    """One CSV column as pandas.read_csv types it: ints if every cell is one,
    else floats (NaN for an NA cell) if every cell parses, else strings
    (NaN for an NA cell). A missing cell is None."""
    try:
        return [int(c) for c in cells]
    except (TypeError, ValueError):
        pass
    try:
        return [math.nan if c is None or c.strip() in PANDAS_NA else float(c) for c in cells]
    except ValueError:
        return [math.nan if c is None or c in PANDAS_NA else c for c in cells]


def read_table(path: str) -> dict:
    """A CSV as {column: [typed cells]} in the file's column order, blank
    lines skipped (pandas.read_csv's defaults)."""
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.DictReader(f)
        rows = list(reader)
        names = reader.fieldnames or []
    return {name: _typed([r[name] for r in rows]) for name in names}


def _cell(v) -> str:
    if isinstance(v, float):
        return "" if math.isnan(v) else repr(v)
    return str(v)


def write_table(table: dict, path: str) -> None:
    """`DataFrame.to_csv(path, index=False)` of the table: integers as
    integers, floats as repr(float), NaN as an empty field, minimal
    quoting, '\\n' line ends."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(list(table))
        w.writerows(zip(*[[_cell(v) for v in col] for col in table.values()]))


def _mean(values: list) -> float:
    """pandas' Series.mean: NaN skipped, NaN if nothing is left."""
    kept = [v for v in values if not math.isnan(v)]
    return float(np.mean(kept)) if kept else math.nan


@torch.inference_mode()
def clip_scores(
    im_path: str,
    prompt: str,
    prompts_csv: str,
    clip_params: dict,
    vision_cfg,
    text_cfg,
    tokenizer,
    batch_size: int = 16,
) -> dict:
    """Per-case mean CLIP logits_per_image against `prompt` for every scale
    folder, on the device of `clip_params`; writes {im_path}/clip_scores.csv
    like clip_score.py:24-72 and returns the table ({column: cells})."""
    from sliders_tpu_torch.data.native_loader import decode_file
    from sliders_tpu_torch.models.clip_vision import clip_logits_per_image, preprocess_images

    device = clip_params["logit_scale"].device
    ids = torch.as_tensor(tokenizer([prompt.strip()]), dtype=torch.long, device=device)
    table = read_table(prompts_csv)
    cases_in_df = set(table["case_number"])
    for folder in _scale_folders(im_path):
        col = f"clip_{folder.replace('half', '0.5')}"
        table[col] = [math.nan] * len(table["case_number"])
        folder_path = os.path.join(im_path, folder)
        names, cases = [], []
        for name in sorted_nicely(os.listdir(folder_path)):
            try:
                case = int(name.split("_")[0].replace(".png", ""))
            except ValueError:
                continue
            if case in cases_in_df:
                names.append(name)
                cases.append(case)
        per_case: dict = {}
        for start in range(0, len(names), batch_size):
            imgs = np.stack([decode_file(os.path.join(folder_path, n))
                             for n in names[start:start + batch_size]])
            with tf32_flags(False, False):
                pixels = preprocess_images(torch.from_numpy(imgs).to(device),
                                           vision_cfg.image_size)
                vals = clip_logits_per_image(clip_params, pixels, ids, vision_cfg,
                                             text_cfg)[:, 0].cpu().tolist()
            for case, v in zip(cases[start:start + batch_size], vals):
                per_case.setdefault(case, []).append(v)
        for case, vals in per_case.items():
            mean = float(np.mean(vals))
            table[col] = [mean if c == case else v for c, v in zip(table["case_number"],
                                                                   table[col])]
        print(f"Mean CLIP score [{folder}]: {_mean(table[col])}")
    write_table(table, os.path.join(im_path, "clip_scores.csv"))
    return table


@torch.inference_mode()
def lpips_scores(
    im_path: str,
    true_folder: str,
    prompts_csv: str,
    lpips_params: dict,
) -> dict:
    """LPIPS (64 px) of each scale folder vs the `true_folder` (scale 0),
    per case, on the device of `lpips_params`; writes
    {im_path}/lpips_score.csv like lpip_score.py:47-76 and returns the
    table."""
    from sliders_tpu_torch.evals.lpips import load_image_64, lpips_distance

    device = lpips_params["lins"]["0"]["weight"].device
    table = read_table(prompts_csv)
    original_path = os.path.join(im_path, true_folder)
    for folder in _scale_folders(im_path, exclude=(true_folder,)):
        col = f"lpips_{folder.replace('half', '0.5')}"
        table[col] = [0.0] * len(table["case_number"])
        edited = os.path.join(im_path, folder)
        files = [f for f in os.listdir(edited) if f.endswith(".png")]
        for index, case in enumerate(table["case_number"]):
            vals = []
            for f in files:
                if not f.startswith(f"{case}_"):
                    continue
                orig_file = os.path.join(original_path, f)
                if not os.path.exists(orig_file):
                    continue
                a = load_image_64(orig_file).to(device)
                b = load_image_64(os.path.join(edited, f)).to(device)
                with tf32_flags(False, False):
                    vals.append(float(lpips_distance(lpips_params, a, b)[0]))
            table[col][index] = float(np.mean(vals)) if vals else math.nan
    write_table(table, os.path.join(im_path, "lpips_score.csv"))
    return table
