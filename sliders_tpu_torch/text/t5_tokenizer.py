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
  characters by its own. Clusters are cut by every rule of UAX #29 that
  the `tokenizers` library applies: CR LF, controls, Hangul syllable
  sequences, combining and spacing marks, prepended marks, emoji
  zero-width-joiner sequences and regional-indicator pairs (`graphemes`);
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
import bisect
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
_ZWJ = 0x200D
# Code-point ranges (inclusive) of Grapheme_Cluster_Break Prepend, L, V and
# T, and of Extended_Pictographic, as the `regex` package 2026.7.19 gives
# them (\p{Grapheme_Cluster_Break=Prepend}, =L, =V, =T and
# \p{Extended_Pictographic}). Hangul LV and LVT syllables follow from the
# syllable arithmetic: U+AC00..U+D7A3, LV where (cp - 0xAC00) % 28 == 0.
_PREPEND = ((0x600, 0x605), (0x6DD, 0x6DD), (0x70F, 0x70F), (0x890, 0x891), (0x8E2, 0x8E2),
            (0xD4E, 0xD4E), (0x110BD, 0x110BD), (0x110CD, 0x110CD), (0x111C2, 0x111C3),
            (0x113D1, 0x113D1), (0x1193F, 0x1193F), (0x11941, 0x11941), (0x11A84, 0x11A89),
            (0x11D46, 0x11D46), (0x11F02, 0x11F02))
_HANGUL = {"L": ((0x1100, 0x115F), (0xA960, 0xA97C)),
           "V": ((0x1160, 0x11A7), (0xD7B0, 0xD7C6), (0x16D63, 0x16D63), (0x16D67, 0x16D6A)),
           "T": ((0x11A8, 0x11FF), (0xD7CB, 0xD7FB))}
_PICTOGRAPHIC = (
    (0xA9, 0xA9), (0xAE, 0xAE), (0x203C, 0x203C), (0x2049, 0x2049), (0x2122, 0x2122),
    (0x2139, 0x2139), (0x2194, 0x2199), (0x21A9, 0x21AA), (0x231A, 0x231B), (0x2328, 0x2328),
    (0x23CF, 0x23CF), (0x23E9, 0x23F3), (0x23F8, 0x23FA), (0x24C2, 0x24C2), (0x25AA, 0x25AB),
    (0x25B6, 0x25B6), (0x25C0, 0x25C0), (0x25FB, 0x25FE), (0x2600, 0x2604), (0x260E, 0x260E),
    (0x2611, 0x2611), (0x2614, 0x2615), (0x2618, 0x2618), (0x261D, 0x261D), (0x2620, 0x2620),
    (0x2622, 0x2623), (0x2626, 0x2626), (0x262A, 0x262A), (0x262E, 0x262F), (0x2638, 0x263A),
    (0x2640, 0x2640), (0x2642, 0x2642), (0x2648, 0x2653), (0x265F, 0x2660), (0x2663, 0x2663),
    (0x2665, 0x2666), (0x2668, 0x2668), (0x267B, 0x267B), (0x267E, 0x267F), (0x2692, 0x2697),
    (0x2699, 0x2699), (0x269B, 0x269C), (0x26A0, 0x26A1), (0x26A7, 0x26A7), (0x26AA, 0x26AB),
    (0x26B0, 0x26B1), (0x26BD, 0x26BE), (0x26C4, 0x26C5), (0x26C8, 0x26C8), (0x26CE, 0x26CF),
    (0x26D1, 0x26D1), (0x26D3, 0x26D4), (0x26E9, 0x26EA), (0x26F0, 0x26F5), (0x26F7, 0x26FA),
    (0x26FD, 0x26FD), (0x2702, 0x2702), (0x2705, 0x2705), (0x2708, 0x270D), (0x270F, 0x270F),
    (0x2712, 0x2712), (0x2714, 0x2714), (0x2716, 0x2716), (0x271D, 0x271D), (0x2721, 0x2721),
    (0x2728, 0x2728), (0x2733, 0x2734), (0x2744, 0x2744), (0x2747, 0x2747), (0x274C, 0x274C),
    (0x274E, 0x274E), (0x2753, 0x2755), (0x2757, 0x2757), (0x2763, 0x2764), (0x2795, 0x2797),
    (0x27A1, 0x27A1), (0x27B0, 0x27B0), (0x27BF, 0x27BF), (0x2934, 0x2935), (0x2B05, 0x2B07),
    (0x2B1B, 0x2B1C), (0x2B50, 0x2B50), (0x2B55, 0x2B55), (0x3030, 0x3030), (0x303D, 0x303D),
    (0x3297, 0x3297), (0x3299, 0x3299), (0x1F004, 0x1F004), (0x1F02C, 0x1F02F),
    (0x1F094, 0x1F09F), (0x1F0AF, 0x1F0B0), (0x1F0C0, 0x1F0C0), (0x1F0CF, 0x1F0D0),
    (0x1F0F6, 0x1F0FF), (0x1F170, 0x1F171), (0x1F17E, 0x1F17F), (0x1F18E, 0x1F18E),
    (0x1F191, 0x1F19A), (0x1F1AE, 0x1F1E5), (0x1F201, 0x1F20F), (0x1F21A, 0x1F21A),
    (0x1F22F, 0x1F22F), (0x1F232, 0x1F23A), (0x1F23C, 0x1F23F), (0x1F249, 0x1F25F),
    (0x1F266, 0x1F321), (0x1F324, 0x1F393), (0x1F396, 0x1F397), (0x1F399, 0x1F39B),
    (0x1F39E, 0x1F3F0), (0x1F3F3, 0x1F3F5), (0x1F3F7, 0x1F3FA), (0x1F400, 0x1F4FD),
    (0x1F4FF, 0x1F53D), (0x1F549, 0x1F54E), (0x1F550, 0x1F567), (0x1F56F, 0x1F570),
    (0x1F573, 0x1F57A), (0x1F587, 0x1F587), (0x1F58A, 0x1F58D), (0x1F590, 0x1F590),
    (0x1F595, 0x1F596), (0x1F5A4, 0x1F5A5), (0x1F5A8, 0x1F5A8), (0x1F5B1, 0x1F5B2),
    (0x1F5BC, 0x1F5BC), (0x1F5C2, 0x1F5C4), (0x1F5D1, 0x1F5D3), (0x1F5DC, 0x1F5DE),
    (0x1F5E1, 0x1F5E1), (0x1F5E3, 0x1F5E3), (0x1F5E8, 0x1F5E8), (0x1F5EF, 0x1F5EF),
    (0x1F5F3, 0x1F5F3), (0x1F5FA, 0x1F64F), (0x1F680, 0x1F6C5), (0x1F6CB, 0x1F6D2),
    (0x1F6D5, 0x1F6E5), (0x1F6E9, 0x1F6E9), (0x1F6EB, 0x1F6F0), (0x1F6F3, 0x1F6FF),
    (0x1F7DA, 0x1F7FF), (0x1F80C, 0x1F80F), (0x1F848, 0x1F84F), (0x1F85A, 0x1F85F),
    (0x1F888, 0x1F88F), (0x1F8AE, 0x1F8AF), (0x1F8BC, 0x1F8BF), (0x1F8C2, 0x1F8CF),
    (0x1F8D9, 0x1F8FF), (0x1F90C, 0x1F93A), (0x1F93C, 0x1F945), (0x1F947, 0x1F9FF),
    (0x1FA58, 0x1FA5F), (0x1FA6E, 0x1FAFF), (0x1FC00, 0x1FFFD),
)


def _in(ranges, o: int) -> bool:
    """Whether o lies in one of the sorted, disjoint inclusive `ranges`."""
    i = bisect.bisect_right(ranges, (o, 0x10FFFF)) - 1
    return i >= 0 and ranges[i][0] <= o <= ranges[i][1]


def _break_class(c: str) -> str:
    """The Grapheme_Cluster_Break value of c: CR, LF, Control, Extend, ZWJ,
    Regional_Indicator, Prepend, SpacingMark, L, V, T, LV, LVT or Other."""
    o = ord(c)
    if c in "\r\n":
        return "CR" if c == "\r" else "LF"
    if o == _ZWJ:
        return "ZWJ"
    if _in(_PREPEND, o):
        return "Prepend"
    cat = unicodedata.category(c)
    if cat in ("Mn", "Me") or o in _EXTEND_EXTRA:
        return "Extend"
    if cat in ("Cc", "Cf", "Zl", "Zp"):
        return "Control"
    if o in _SPACING_EXTRA or (cat == "Mc" and o not in _MC_OTHER):
        return "SpacingMark"
    if 0x1F1E6 <= o <= 0x1F1FF:
        return "Regional_Indicator"
    if 0xAC00 <= o <= 0xD7A3:
        return "LV" if (o - 0xAC00) % 28 == 0 else "LVT"
    for kind, ranges in _HANGUL.items():
        if _in(ranges, o):
            return kind
    return "Other"


_HANGUL_JOINS = {"L": ("L", "V", "LV", "LVT"), "LV": ("V", "T"), "V": ("V", "T"), "LVT": ("T",),
                 "T": ("T",)}


def graphemes(text: str) -> List[str]:
    """Extended grapheme clusters of `text` (UAX #29, rules GB3-GB13)."""
    out: List[str] = []
    prev = None
    pict = False  # the text so far ends in Extended_Pictographic Extend*
    pict_zwj = False  # ... in Extended_Pictographic Extend* ZWJ
    ris = 0  # regional indicators the text so far ends in
    for c in text:
        cur = _break_class(c)
        is_pict = _in(_PICTOGRAPHIC, ord(c))
        if prev is None:
            join = False
        elif prev == "CR" and cur == "LF":  # GB3
            join = True
        elif prev in ("CR", "LF", "Control") or cur in ("CR", "LF", "Control"):  # GB4, GB5
            join = False
        elif cur in _HANGUL_JOINS.get(prev, ()):  # GB6-GB8
            join = True
        elif cur in ("Extend", "ZWJ", "SpacingMark") or prev == "Prepend":  # GB9-GB9b
            join = True
        elif pict_zwj and is_pict:  # GB11
            join = True
        else:  # GB12, GB13: a pair of regional indicators
            join = cur == prev == "Regional_Indicator" and ris % 2 == 1
        if join:
            out[-1] += c
        else:
            out.append(c)
        pict_zwj = pict and cur == "ZWJ"
        pict = is_pict or (pict and cur == "Extend")
        ris = ris + 1 if cur == "Regional_Indicator" else 0
        prev = cur
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
