"""The port's CLIP tokenizer against sliders_tpu.text.tokenizer: the same
ids, id for id (exact), from the same vocab.json + merges.txt."""

import json

import numpy as np
import pytest

from sliders_tpu.text.tokenizer import ClipTokenizer as JaxClipTokenizer
from sliders_tpu_torch.text.tokenizer import ClipTokenizer

TEXTS = ["photo of an old cat", "OLD   photo!", "cat, cat, cat.", "", "  to to photo's 42 ",
         "cat cat cat cat cat cat cat cat cat cat cat cat", "<|startoftext|>old<|endoftext|>"]


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tok")
    vocab = {}
    for c in "abcdefghijklmnopqrstuvwxyz0123456789!,.'":
        vocab.setdefault(c, len(vocab))
        vocab.setdefault(c + "</w>", len(vocab))
    merges = [("p", "h"), ("ph", "o"), ("pho", "to</w>"), ("o", "l"), ("ol", "d</w>"),
              ("c", "a"), ("ca", "t</w>"), ("t", "o</w>"), ("'", "s</w>")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))
    return str(d)


@pytest.mark.parametrize("pad_token_id", [None, 0])
@pytest.mark.parametrize("max_length", [16, 6])
def test_tokenizer_matches_jax(vocab_dir, max_length, pad_token_id):
    ours = ClipTokenizer.from_pretrained(vocab_dir, pad_token_id=pad_token_id)
    ref = JaxClipTokenizer.from_pretrained(vocab_dir, pad_token_id=pad_token_id)
    ours.model_max_length = ref.model_max_length = max_length
    out = ours(TEXTS)
    assert out.dtype == np.int32 and out.shape == (len(TEXTS), max_length)
    np.testing.assert_array_equal(out, ref(TEXTS))
    assert [ours.tokenize(t) for t in TEXTS] == [ref.tokenize(t) for t in TEXTS]


def test_added_tokens_match_jax(vocab_dir):
    ours, ref = ClipTokenizer.from_pretrained(vocab_dir), JaxClipTokenizer.from_pretrained(vocab_dir)
    for tok in ("<sks>", "<sks>b", "cat", "<sks>"):
        assert ours.add_tokens(tok) == ref.add_tokens(tok)
    assert len(ours) == len(ref)
    text = "a <sks>b photo of <sks> cat"
    assert ours.tokenize(text) == ref.tokenize(text)
    for tok in ("<sks>", "<sks>b", "cat", "photo", "old cat"):
        assert ours.convert_tokens_to_ids(tok) == ref.convert_tokens_to_ids(tok)
