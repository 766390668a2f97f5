"""The port's reader of FLUX's T5 `tokenizer.json`, id for id against
`transformers.T5TokenizerFast` (the JAX package's T5 tokenizer) called as
the FLUX pipeline calls it: padding="max_length", truncation=True.

Two files: the WordLevel + Whitespace one that `tests/helpers.py` writes for
the tiny FLUX snapshot, and a Unigram + Metaspace one built here with the
`tokenizers` library in the shape of a FLUX snapshot's tokenizer_2
(Replace and Strip normalizers, TemplateProcessing appending </s>).
"""

import json
import os

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


def test_precompiled_normalizer_is_identity_on_ascii_only(tmp_path):
    """A snapshot's Precompiled (sentencepiece charsmap) normalizer is taken
    as the identity on printable ASCII; any other character is refused by
    name rather than guessed."""
    _unigram_tokenizer(str(tmp_path))
    path = tmp_path / "tokenizer.json"
    spec = json.loads(path.read_text())
    spec["normalizer"] = {"type": "Sequence", "normalizers": [
        {"type": "Precompiled", "precompiled_charsmap": "AAAA"}, spec["normalizer"]]}
    path.write_text(json.dumps(spec))
    ours = T5Tokenizer.from_pretrained(str(tmp_path))
    plain = T5Tokenizer(json.loads(json.dumps({**spec, "normalizer": None})))
    assert ours.tokenize("a photo of a person") == plain.tokenize("a photo of a person")
    for prompt in ("café", "a\tphoto", "ｆｕｌｌ"):
        with pytest.raises(ValueError, match="ROADMAP queue 3"):
            ours([prompt])


def test_unsupported_pieces_are_refused(tmp_path):
    _unigram_tokenizer(str(tmp_path))
    spec = json.loads((tmp_path / "tokenizer.json").read_text())
    with pytest.raises(ValueError, match="not supported"):
        T5Tokenizer({**spec, "normalizer": {"type": "NFKC"}})
    with pytest.raises(ValueError, match="not supported"):
        T5Tokenizer({**spec, "model": {"type": "BPE", "vocab": {}, "merges": []}})
