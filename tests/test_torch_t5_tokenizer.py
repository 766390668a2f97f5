"""The port's reader of FLUX's T5 `tokenizer.json`, id for id against
`transformers.T5TokenizerFast` (the JAX package's T5 tokenizer) called as
the FLUX pipeline calls it: padding="max_length", truncation=True.

Two files: the WordLevel + Whitespace one that `tests/helpers.py` writes for
the tiny FLUX snapshot, and a Unigram + Metaspace one built here with the
`tokenizers` library in the shape of a FLUX snapshot's tokenizer_2
(Replace and Strip normalizers, TemplateProcessing appending </s>); and the
latter with a `Precompiled` charsmap in front, assembled here, held to
`tokenizers.normalizers.Precompiled` string for string.
"""

import base64
import json
import os
import struct

import numpy as np
import pytest
import transformers
from helpers import make_t5_fast_tokenizer

from sliders_tpu_torch.text.t5_tokenizer import T5Tokenizer

PROMPTS = [
    "a photo of a very old person",
    "a photo of a person, smiling!",
    "  a   photo  of a person  ",
    "",
    "unknown words zebra quartz",
    "photographs of photos: a,b;c",
    "xyz xyzzy photophoto",
    "a " * 40,
    "Upper Case Words",
]


def _unigram_tokenizer(d):
    from tokenizers import Regex, Tokenizer, normalizers, pre_tokenizers, processors
    from tokenizers.models import Unigram

    os.makedirs(d, exist_ok=True)
    vocab = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0), ("▁", -2.5), ("▁a", -3.0),
             ("▁photo", -4.0), ("▁ph", -6.0), ("oto", -6.5), ("photo", -7.0), ("s", -3.5),
             ("▁of", -3.2), ("▁person", -4.5), ("▁per", -6.0), ("son", -6.0), ("▁very", -5.0),
             ("▁old", -4.8), ("▁smil", -7.0), ("ing", -4.0), (",", -3.0), ("!", -4.0),
             ("▁x", -8.0), ("y", -8.5), ("z", -8.5), ("zz", -9.0), ("▁U", -9.0), ("pper", -9.5),
             ("▁C", -9.0), ("ase", -8.0), ("▁W", -9.0), ("ords", -8.0), ("a", -6.0), ("b", -7.0),
             ("c", -7.0), (":", -5.0), ("o", -6.0), ("r", -7.0), ("e", -6.0), ("d", -7.0),
             ("w", -7.5), ("n", -7.0), ("k", -8.0), ("u", -7.0), ("t", -7.0), ("q", -9.0),
             ("h", -7.0), ("p", -7.0), ("g", -7.0), ("i", -6.5), ("l", -6.5), ("m", -7.5)]
    tok = Tokenizer(Unigram(vocab, unk_id=2, byte_fallback=False))
    tok.normalizer = normalizers.Sequence([normalizers.Replace(Regex(" {2,}"), " "),
                                           normalizers.Strip()])
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always")
    tok.post_processor = processors.TemplateProcessing(single="$A </s>",
                                                       special_tokens=[("</s>", 1)])
    tok.save(os.path.join(d, "tokenizer.json"))
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "T5Tokenizer", "eos_token": "</s>", "pad_token": "<pad>",
                   "unk_token": "<unk>", "model_max_length": 512}, f)


@pytest.fixture(scope="module", params=["wordlevel", "unigram"])
def tok_dir(request, tmp_path_factory):
    d = str(tmp_path_factory.mktemp(request.param))
    (make_t5_fast_tokenizer if request.param == "wordlevel" else _unigram_tokenizer)(d)
    return d


@pytest.mark.parametrize("max_length", [512, 16, 4])
def test_ids_equal_t5_tokenizer_fast(tok_dir, max_length):
    ref = transformers.T5TokenizerFast.from_pretrained(tok_dir)
    ours = T5Tokenizer.from_pretrained(tok_dir)
    want = ref(PROMPTS, padding="max_length", max_length=max_length, truncation=True,
               return_tensors="np").input_ids
    got = ours(PROMPTS, max_length=max_length)
    assert got.shape == want.shape == (len(PROMPTS), max_length)
    for p, g, w in zip(PROMPTS, got, want):
        np.testing.assert_array_equal(g, w, err_msg=repr(p))


def test_unigram_segmentation_is_viterbi(tmp_path):
    """The best-scoring split wins over greedy longest match, unknown
    characters become one fused <unk>, and </s> ends the sequence."""
    _unigram_tokenizer(str(tmp_path))
    ours = T5Tokenizer.from_pretrained(str(tmp_path))
    spec = json.loads((tmp_path / "tokenizer.json").read_text())
    ids = {p: i for i, (p, _) in enumerate(spec["model"]["vocab"])}
    assert ours.tokenize("photos") == [ids["▁photo"], ids["s"]]
    assert ours.tokenize("a ##$") == [ids["▁a"], ids["▁"], 2]
    assert list(ours(["a"], max_length=4)[0]) == [ids["▁a"], 1, 0, 0]


# a sentencepiece charsmap in small: full-width letters, a ligature, NBSP and
# a tab to a space, a combining-accent sequence composed, halfwidth kana
# with its voicing mark composed, a deletion, and a prepended mark (a key
# that prefixes the short cluster the mark starts replaces all of it)
CHARSMAP = {**{chr(0xFF21 + i): chr(0x41 + i) for i in range(26)},
            **{chr(0xFF41 + i): chr(0x61 + i) for i in range(26)},
            "\ufb01": "fi", "\u00a0": " ", "\t": " ", "e\u0301": "\u00e9",
            "A\u0300": "\u00c0", "\uff76\uff9e": "\u30ac", "\u00ad": "", "\u0600": "P"}
CHARSMAP_PROMPTS = [
    "ＡＢＣ ｄｅｆ photo", "ﬁne ﬂour", "a\u00a0photo of\u00a0a person", "a\tphoto\t\tof",
    "cafe\u0301 Ae\u0301", "A\u0300 la carte", "ａ\u0301b",  # a key prefixes the cluster
    "e\u0301\u0301", "e\u0301\u0302\u0303x",  # a cluster of 7 bytes: char by char
    "\t\u0301", "x\u00ady", "ｶﾞｷﾞ", "naïve café", "写真 of a person", "line\r\nbreak",
    "plain ascii prompt", "",
]


def _charsmap_blob(mapping: dict) -> bytes:
    """A precompiled_charsmap as sentencepiece lays it out: a little-endian
    u32 trie size, a darts-clone double array over the keys' UTF-8 bytes
    (each node's children in a block of 256 units of its own, the leaf's
    value unit at label 0), then the NUL-terminated values."""
    pool, values = b"", {}
    for key, val in mapping.items():
        values[key.encode()] = len(pool)
        pool += val.encode() + b"\0"
    trie: dict = {}
    for key in values:
        node = trie
        for byte in key:
            node = node.setdefault(byte, {})
        node[None] = values[key]
    units = [0] * 256

    def place(node: dict, pos: int) -> None:
        base = len(units)  # a multiple of 256: child c at base ^ c = base + c
        units.extend([0] * 256)
        units[pos] |= (pos ^ base) << 10  # offset
        if None in node:
            units[pos] |= 1 << 8  # has a leaf
            units[base] = node[None] | (1 << 31)
        for byte, child in sorted((b, c) for b, c in node.items() if b is not None):
            units[base + byte] = byte  # label
            place(child, base + byte)

    place(trie, 0)
    return struct.pack("<I", 4 * len(units)) + struct.pack(f"<{len(units)}I", *units) + pool


def _precompiled_tokenizer(d):
    """The Unigram file with a Precompiled step in front, as a FLUX
    snapshot's T5 tokenizer has it."""
    _unigram_tokenizer(d)
    path = os.path.join(d, "tokenizer.json")
    spec = json.loads(open(path).read())
    blob = base64.b64encode(_charsmap_blob(CHARSMAP)).decode()
    spec["normalizer"] = {"type": "Sequence", "normalizers": [
        {"type": "Precompiled", "precompiled_charsmap": blob}, spec["normalizer"]]}
    with open(path, "w") as f:
        json.dump(spec, f)
    return blob


@pytest.mark.parametrize("prompt", CHARSMAP_PROMPTS)
def test_precompiled_normalizer_equals_tokenizers(tmp_path, prompt):
    """The port's Precompiled step gives the string that
    `tokenizers.normalizers.Precompiled` gives on the same charsmap,
    quirks included (a key that prefixes a short cluster replaces all of
    it; a cluster of 6 bytes or more goes character by character)."""
    from tokenizers import normalizers

    blob = base64.b64decode(_precompiled_tokenizer(str(tmp_path)))
    ours = T5Tokenizer.from_pretrained(str(tmp_path))
    step = ours.normalizers[0]
    assert step["type"] == "Precompiled"
    want = normalizers.Precompiled(blob).normalize_str(prompt)
    assert ours.charsmaps[id(step)].normalize(prompt) == want


def test_precompiled_ids_equal_t5_tokenizer_fast(tmp_path):
    """Through the whole tokenizer: the port's ids equal T5TokenizerFast's
    on a file with the charsmap in front of Replace and Strip."""
    _precompiled_tokenizer(str(tmp_path))
    ref = transformers.T5TokenizerFast.from_pretrained(str(tmp_path))
    ours = T5Tokenizer.from_pretrained(str(tmp_path))
    want = ref(CHARSMAP_PROMPTS, padding="max_length", max_length=32, truncation=True,
               return_tensors="np").input_ids
    got = ours(CHARSMAP_PROMPTS, max_length=32)
    for p, g, w in zip(CHARSMAP_PROMPTS, got, want):
        np.testing.assert_array_equal(g, w, err_msg=repr(p))


# clusters cut by the UAX #29 rules for Hangul syllables (GB6-GB8), prepended
# marks (GB9b), emoji zero-width-joiner sequences (GB11) and regional
# indicator pairs (GB12, GB13)
CLUSTER_PROMPTS = [
    "a 👩\u200d💻 person", "🇫🇷 flag", "\u1100\u1161 jamo", "\u0600x",
    "a 👨\u200d👩\u200d👧\u200d👦 family", "👩🏽\u200d💻 at work", "🇫🇷🇩🇪 two flags",
    "🇫🇷🇩 three indicators", "\uac00\u11a8 LV + T", "\u1100\u1161\u11a8 L V T",
    "\uac01\u11a8\u11a8 LVT T T", "\u0600a letter", "\u0600 space", "a\u200db",
]


@pytest.mark.parametrize("prompt", CLUSTER_PROMPTS)
def test_precompiled_refuses_clusters_it_cannot_cut(tmp_path, prompt):
    """Prompts whose clusters need the Hangul, prepend, emoji ZWJ and
    regional-indicator rules are cut as the `tokenizers` library cuts them:
    the Precompiled step gives its string and the whole tokenizer
    T5TokenizerFast's ids; nothing is refused."""
    from tokenizers import normalizers

    blob = base64.b64decode(_precompiled_tokenizer(str(tmp_path)))
    ours = T5Tokenizer.from_pretrained(str(tmp_path))
    step = ours.normalizers[0]
    assert ours.charsmaps[id(step)].normalize(prompt) == \
        normalizers.Precompiled(blob).normalize_str(prompt)
    ref = transformers.T5TokenizerFast.from_pretrained(str(tmp_path))
    want = ref([prompt], padding="max_length", max_length=32, truncation=True,
               return_tensors="np").input_ids
    np.testing.assert_array_equal(ours([prompt], max_length=32), want)


# characters of every Grapheme_Cluster_Break class the rules name: CR, LF,
# controls, Extend (combining acute, variation selector 16, a skin tone),
# ZWJ, regional indicators, Prepend, SpacingMark, Hangul L, V, T, LV and
# LVT, Extended_Pictographic (emoji, (c)), letters and spaces
CLUSTER_POOL = ("\r", "\n", "\x00", "\u200e", "\u0301", "\ufe0f", "\U0001F3FD", "\u200d",
                "\U0001F1EB", "\U0001F1F7", "\u0600", "\U000110BD", "\u0903", "\u1100",
                "\ua960", "\u1161", "\ud7b0", "\u11a8", "\ud7cb", "\uac00", "\uac01",
                "\U0001F469", "\U0001F4BB", "\u00a9", "\u2764", "a", "x", " ")


@pytest.mark.parametrize("seed", range(4))
def test_graphemes_match_regex(seed):
    """`graphemes` cuts 500 random strings over CLUSTER_POOL as the `regex`
    package's \\X does (the package its tables were taken from)."""
    regex = pytest.importorskip("regex")
    from sliders_tpu_torch.text.t5_tokenizer import graphemes

    rng = np.random.default_rng(seed)
    for _ in range(500):
        text = "".join(rng.choice(CLUSTER_POOL, size=int(rng.integers(1, 12))))
        assert graphemes(text) == regex.findall(r"\X", text), repr(text)


def test_unsupported_pieces_are_refused(tmp_path):
    _unigram_tokenizer(str(tmp_path))
    spec = json.loads((tmp_path / "tokenizer.json").read_text())
    with pytest.raises(ValueError, match="not supported"):
        T5Tokenizer({**spec, "normalizer": {"type": "NFKC"}})
    with pytest.raises(ValueError, match="not supported"):
        T5Tokenizer({**spec, "model": {"type": "BPE", "vocab": {}, "merges": []}})
