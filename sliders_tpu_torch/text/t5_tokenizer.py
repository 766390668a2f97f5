"""Reader of a `tokenizer.json` for FLUX's T5 encoder (tokenizer_2/), with
no `transformers`, `tokenizers` or `sentencepiece`.

The JAX package loads `transformers.T5TokenizerFast` (sliders_tpu/models/
loader.py:200-208) and calls it with padding="max_length",
max_length=512, truncation=True. This reads the same file and gives the same
ids (`tests/test_torch_t5_tokenizer.py` holds it to T5TokenizerFast id for
id). It takes the pieces a FLUX snapshot's T5 tokenizer uses, and the
WordLevel files the tests write:

- models: `Unigram` (Viterbi over piece scores; characters no piece covers
  become `unk_id`, consecutive ones fused, as the `tokenizers` library
  does) and `WordLevel` (unknown words -> its unk token);
- normalizers: `Sequence`, `Replace` (string or regex), `Strip`, and
  `Precompiled`: sentencepiece's charsmap (a darts-clone double array over
  UTF-8 and a pool of replacement strings), applied as the `tokenizers`
  library applies it (`_Charsmap`). The text is cut into extended grapheme
  clusters; a cluster shorter than 6 UTF-8 bytes is replaced whole by the
  value of the first key of the trie that prefixes it, else each of its
  characters by its own. Clusters are cut by the rules that need no
  emoji or Hangul tables (CR LF, controls, combining and spacing marks); a
  prompt with a zero-width joiner, a regional indicator, a conjoining
  Hangul jamo or a prepended concatenation mark raises a ValueError naming
  ROADMAP queue 3 rather than being cut by a guess;
- pre-tokenizers: `Metaspace` ('▁', prefix space), `WhitespaceSplit`,
  `Whitespace`, `Sequence`;
- post-processor: `TemplateProcessing`'s single template (T5 appends
  `</s>`) or none;
- added tokens, matched whole in the raw text before anything else.

Truncation keeps max_length minus the template's special tokens, then the
template adds them; padding fills with the pad token on the right.
"""

from __future__ import annotations

import base64
import json
import os
import re
import struct
import unicodedata
from typing import List, Optional

import numpy as np

_UNK_PENALTY = 10.0  # the tokenizers library's K_UNK_PENALTY
_WHITESPACE = re.compile(r"\w+|[^\w\s]+")

# Grapheme_Cluster_Break values beyond the general category (Unicode's
# UAX #29 table): Extend characters that are not marks, SpacingMark
# characters that are not Mc, and the Mc characters that are neither
_EXTEND_EXTRA = ({0x200C, 0xFF9E, 0xFF9F} | set(range(0xE0020, 0xE0080))
                 | set(range(0x1F3FB, 0x1F400)))  # ZWNJ, halfwidth kana marks, tags, skin tones
_SPACING_EXTRA = {0x0E33, 0x0EB3}
_MC_OTHER = ({0x102B, 0x102C, 0x1038, 0x1083, 0x108F, 0x1A61, 0x1A63, 0x1A64, 0xAA7B, 0xAA7D,
              0x11720, 0x11721} | set(range(0x1062, 0x1065)) | set(range(0x1067, 0x106E))
             | set(range(0x1087, 0x108D)) | set(range(0x109A, 0x109D)))
# what the cluster rules here do not cover (GB6-8, GB9b, GB11-13)
_UNSUPPORTED = ((0x1100, 0x11FF), (0xA960, 0xA97F), (0xD7B0, 0xD7FF),  # conjoining jamo
                (0x1F1E6, 0x1F1FF),  # regional indicators
                (0x200D, 0x200D),  # zero-width joiner
                (0x0600, 0x0605), (0x06DD, 0x06DD), (0x070F, 0x070F), (0x0890, 0x0891),
                (0x08E2, 0x08E2), (0x0D4E, 0x0D4E), (0x110BD, 0x110BD), (0x110CD, 0x110CD),
                (0x111C2, 0x111C3), (0x1193F, 0x1193F), (0x11941, 0x11941), (0x11A3A, 0x11A3A),
                (0x11A84, 0x11A89), (0x11D46, 0x11D46), (0x11F02, 0x11F02))  # prepend
_UNSUPPORTED_MSG = ("the Precompiled normalizer's grapheme clusters are ported without the emoji, "
                    "regional-indicator, Hangul-jamo and prepend rules (ROADMAP queue 3); prompt "
                    "{!r} has {!r}")


def _joins_previous(c: str) -> bool:
    """Whether no cluster boundary falls before c (GB9, GB9a): Extend or
    SpacingMark."""
    o = ord(c)
    cat = unicodedata.category(c)
    return (cat in ("Mn", "Me") or o in _EXTEND_EXTRA or o in _SPACING_EXTRA
            or (cat == "Mc" and o not in _MC_OTHER))


def _is_control(c: str) -> bool:
    """Grapheme_Cluster_Break Control, CR or LF (GB4, GB5)."""
    cat = unicodedata.category(c)
    return cat in ("Cc", "Zl", "Zp") or (cat == "Cf" and ord(c) not in _EXTEND_EXTRA)


def graphemes(text: str) -> List[str]:
    """Extended grapheme clusters of `text` (UAX #29) for text without the
    characters of `_UNSUPPORTED` (a ValueError names the first)."""
    out: List[str] = []
    prev = None
    for c in text:
        o = ord(c)
        for lo, hi in _UNSUPPORTED:
            if lo <= o <= hi:
                raise ValueError(_UNSUPPORTED_MSG.format(text, c))
        if prev is not None and ((prev == "\r" and c == "\n") or (
                not _is_control(prev) and not _is_control(c) and _joins_previous(c))):
            out[-1] += c
        else:
            out.append(c)
        prev = c
    return out


class _Charsmap:
    """A `Precompiled` normalizer's `precompiled_charsmap`: a little-endian
    u32 trie size in bytes, the darts-clone double array (u32 units) over
    UTF-8 keys, then a pool of NUL-terminated replacement strings that the
    trie's values index by byte offset."""

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError("precompiled_charsmap is shorter than its 4-byte header")
        size = struct.unpack_from("<I", blob)[0]
        if size % 4 or 4 + size > len(blob):
            raise ValueError(f"precompiled_charsmap's trie size {size} does not fit its "
                             f"{len(blob)} bytes")
        self.units = struct.unpack_from(f"<{size // 4}I", blob, 4)
        self.pool = blob[4 + size:]

    @staticmethod
    def _offset(unit: int) -> int:
        return (unit >> 10) << ((unit & (1 << 9)) >> 6)

    def transform(self, chunk: str) -> Optional[str]:
        """The replacement of the first (shortest) key that prefixes chunk's
        UTF-8 bytes, or None (darts-clone's common prefix search, first
        result, as the `tokenizers` library takes it)."""
        units = self.units
        pos = self._offset(units[0])
        for byte in chunk.encode("utf-8"):
            if byte == 0:
                break
            pos ^= byte
            if pos >= len(units):
                return None
            unit = units[pos]
            if unit & ((1 << 31) | 0xFF) != byte:  # label
                return None
            pos ^= self._offset(unit)
            if (unit >> 8) & 1 and pos < len(units):  # has a leaf: its value
                start = units[pos] & ((1 << 31) - 1)
                end = self.pool.find(b"\0", start)
                return self.pool[start:end if end >= 0 else len(self.pool)].decode("utf-8")
        return None

    def normalize(self, text: str) -> str:
        out = []
        for cluster in graphemes(text):
            if len(cluster.encode("utf-8")) < 6:
                norm = self.transform(cluster)
                if norm is not None:
                    out.append(norm)
                    continue
            for c in cluster:
                norm = self.transform(c)
                out.append(c if norm is None else norm)
        return "".join(out)


def _pattern(spec: dict) -> re.Pattern:
    if "Regex" in spec:
        return re.compile(spec["Regex"])
    return re.compile(re.escape(spec["String"]))


class T5Tokenizer:
    """Tokenizes with a `tokenizer.json` (see the module docstring)."""

    def __init__(self, spec: dict, pad_token: str = "<pad>", model_max_length: int = 512):
        model = spec["model"]
        self.kind = model["type"]
        if self.kind == "Unigram":
            if model.get("byte_fallback"):
                raise ValueError("Unigram byte_fallback is not supported")
            self.pieces = [p for p, _ in model["vocab"]]
            self.scores = [float(s) for _, s in model["vocab"]]
            self.unk_id = model.get("unk_id")
            self.unk_score = min(self.scores) - _UNK_PENALTY
            self.vocab = {p: i for i, p in enumerate(self.pieces)}
            self.max_piece = max(len(p) for p in self.pieces)
        elif self.kind == "WordLevel":
            self.vocab = dict(model["vocab"])
            self.unk_id = self.vocab.get(model.get("unk_token"))
        else:
            raise ValueError(f"tokenizer model {self.kind!r} is not supported")
        self.added = {t["content"]: t["id"] for t in spec.get("added_tokens") or []}
        self.normalizers = self._flatten(spec.get("normalizer"), "normalizers")
        self.charsmaps = {id(step): _Charsmap(base64.b64decode(step["precompiled_charsmap"]))
                          for step in self.normalizers if step["type"] == "Precompiled"}
        self.pre_tokenizers = self._flatten(spec.get("pre_tokenizer"), "pretokenizers")
        for step in self.normalizers + self.pre_tokenizers:
            if step["type"] not in ("Replace", "Strip", "Precompiled", "Metaspace",
                                    "WhitespaceSplit", "Whitespace"):
                raise ValueError(f"tokenizer step {step['type']!r} is not supported")
        self.suffix = self._template(spec.get("post_processor"))
        self.pad_token_id = self._id(pad_token)
        self.model_max_length = model_max_length

    @staticmethod
    def _flatten(step: Optional[dict], key: str) -> list:
        if step is None:
            return []
        if step["type"] == "Sequence":
            return [s for sub in step[key] for s in T5Tokenizer._flatten(sub, key)]
        return [step]

    def _template(self, post: Optional[dict]) -> list:
        """Ids the single template appends (T5: [</s>]); only `$A` then
        special tokens is supported."""
        if post is None:
            return []
        if post["type"] != "TemplateProcessing":
            raise ValueError(f"post-processor {post['type']!r} is not supported")
        items = post["single"]
        if "Sequence" not in items[0]:
            raise ValueError("only templates that start with the sequence are supported")
        ids = []
        for item in items[1:]:
            if "SpecialToken" not in item:
                raise ValueError("only special tokens may follow the sequence")
            ids.extend(post["special_tokens"][item["SpecialToken"]["id"]]["ids"])
        return ids

    @classmethod
    def from_pretrained(cls, path: str) -> "T5Tokenizer":
        """`path` is a local tokenizer directory (tokenizer.json, and
        tokenizer_config.json for the pad token and maximum length)."""
        with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
            spec = json.load(f)
        config = {}
        config_path = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(config_path):
            with open(config_path, encoding="utf-8") as f:
                config = json.load(f)
        pad = config.get("pad_token", "<pad>")
        if isinstance(pad, dict):  # an AddedToken record
            pad = pad["content"]
        return cls(spec, pad_token=pad, model_max_length=config.get("model_max_length", 512))

    def _id(self, token: str) -> int:
        return self.added[token] if token in self.added else self.vocab[token]

    def _normalize(self, text: str) -> str:
        for step in self.normalizers:
            kind = step["type"]
            if kind == "Replace":
                text = _pattern(step["pattern"]).sub(step["content"], text)
            elif kind == "Strip":
                if step.get("strip_left", True):
                    text = text.lstrip()
                if step.get("strip_right", True):
                    text = text.rstrip()
            else:  # Precompiled
                text = self.charsmaps[id(step)].normalize(text)
        return text

    def _pre_tokenize(self, text: str) -> list:
        words = [text]
        for step in self.pre_tokenizers:
            kind = step["type"]
            out = []
            for w in words:
                if kind == "WhitespaceSplit":
                    out.extend(w.split())
                elif kind == "Whitespace":
                    out.extend(_WHITESPACE.findall(w))
                else:  # Metaspace
                    out.extend(self._metaspace(step, w))
            words = out
        return words

    @staticmethod
    def _metaspace(step: dict, text: str) -> list:
        rep = step.get("replacement", "▁")
        scheme = step.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if step.get("add_prefix_space", True) else "never"
        text = text.replace(" ", rep)
        if scheme != "never" and text and not text.startswith(rep):
            text = rep + text
        if not step.get("split", True):
            return [text] if text else []
        # split before each replacement character, which starts its piece
        return [w for w in re.split(f"(?={re.escape(rep)})", text) if w]

    def _viterbi(self, text: str) -> list:
        """The best Unigram segmentation of one pre-tokenized word (ids)."""
        n = len(text)
        best = [None] * (n + 1)  # (score, start, id) of the best path ending here
        best[0] = (0.0, 0, -1)
        for start in range(n):
            if best[start] is None:
                continue
            base = best[start][0]
            single = False
            for end in range(start + 1, min(n, start + self.max_piece) + 1):
                piece_id = self.vocab.get(text[start:end])
                if piece_id is None:
                    continue
                score = base + self.scores[piece_id]
                if best[end] is None or score > best[end][0]:
                    best[end] = (score, start, piece_id)
                single = single or end == start + 1
            if not single:
                score = base + self.unk_score
                if best[start + 1] is None or score > best[start + 1][0]:
                    best[start + 1] = (score, start, self.unk_id)
        ids, end, fused_unk = [], n, False
        while end > 0:
            _, start, piece_id = best[end]
            if piece_id == self.unk_id:
                if not fused_unk:  # consecutive unknowns are one unk token
                    ids.append(piece_id)
                fused_unk = True
            else:
                ids.append(piece_id)
                fused_unk = False
            end = start
        return ids[::-1]

    def _word_ids(self, word: str) -> list:
        if self.kind == "WordLevel":
            return [self.vocab.get(word, self.unk_id)]
        return self._viterbi(word)

    def tokenize(self, text: str) -> List[int]:
        """Ids of one prompt without the template's special tokens."""
        ids = []
        chunks = [text]
        if self.added:
            pat = "(" + "|".join(re.escape(t) for t in sorted(self.added, key=len,
                                                              reverse=True)) + ")"
            chunks = re.split(pat, text)
        for chunk in chunks:
            if chunk in self.added:
                ids.append(self.added[chunk])
            elif chunk:
                for word in self._pre_tokenize(self._normalize(chunk)):
                    ids.extend(self._word_ids(word))
        return ids

    def __call__(self, prompts: List[str] | str, max_length: Optional[int] = None) -> np.ndarray:
        """(B, max_length) int64 ids: each prompt truncated to leave room for
        the template's tokens, the template applied, then right-padded with
        the pad token (T5TokenizerFast(padding="max_length",
        truncation=True))."""
        if isinstance(prompts, str):
            prompts = [prompts]
        L = max_length or self.model_max_length
        out = np.full((len(prompts), L), self.pad_token_id, np.int64)
        for i, p in enumerate(prompts):
            ids = (self.tokenize(p)[:max(L - len(self.suffix), 0)] + self.suffix)[:L]
            out[i, :len(ids)] = ids
        return out
