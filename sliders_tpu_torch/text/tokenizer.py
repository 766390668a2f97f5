"""Self-contained CLIP BPE tokenizer (port of sliders_tpu/text/tokenizer.py).

Loads vocab.json + merges.txt from a local snapshot directory and tokenizes
with the reference contract (bos + tokens + eos, truncated and padded to
model_max_length; train_util.text_tokenize, train_util.py:60-70). Pure
Python and numpy; `tests/test_torch_tokenizer.py` holds it to the JAX
package's tokenizer id for id.

SDXL's second tokenizer pads with token id 0 instead of the EOS id
(model_util.py:150 `pad_token_id=0`): pass `pad_token_id` accordingly.
"""

from __future__ import annotations

import json
import os
import re
from typing import List, Optional

import numpy as np

_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
    re.IGNORECASE,
)


def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2/CLIP reversible byte->unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class ClipTokenizer:
    def __init__(
        self,
        vocab: dict[str, int],
        merges: list[tuple[str, str]],
        model_max_length: int = 77,
        pad_token_id: Optional[int] = None,
        bos_token: str = "<|startoftext|>",
        eos_token: str = "<|endoftext|>",
    ):
        self.vocab = vocab
        self.model_max_length = model_max_length
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.bos_token_id = vocab[bos_token]
        self.eos_token_id = vocab[eos_token]
        self.pad_token_id = self.eos_token_id if pad_token_id is None else pad_token_id
        self.cache = {bos_token: bos_token, eos_token: eos_token}
        # user-added tokens (custom-diffusion modifier tokens etc.), matched
        # whole before BPE, as HF tokenizer.add_tokens does
        self.added_tokens: dict[str, int] = {}

    @classmethod
    def from_pretrained(cls, path: str, pad_token_id: Optional[int] = None) -> "ClipTokenizer":
        """`path` is a local tokenizer directory (vocab.json + merges.txt)."""
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            for line in f.read().split("\n"):
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(vocab, merges, pad_token_id=pad_token_id)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def __len__(self) -> int:
        return len(self.vocab) + len(self.added_tokens)

    def add_tokens(self, token: str) -> int:
        """Register a new whole-word token (e.g. a custom-diffusion modifier
        token like '<sks-eyebrows>'); returns the number added (0 if it
        already exists, as HF `tokenizer.add_tokens`). The new id is
        `len(tokenizer) - 1`: callers must grow the embedding matrix."""
        token = token.strip().lower()
        if token in self.vocab or token in self.added_tokens:
            return 0
        self.added_tokens[token] = len(self.vocab) + len(self.added_tokens)
        return 1

    def convert_tokens_to_ids(self, token: str) -> int:
        """Single token -> single id (HF contract: a string that is not one
        vocabulary/added token maps to the eos id, never a list)."""
        token = token.strip().lower()
        if token in self.added_tokens:
            return self.added_tokens[token]
        ids = self.tokenize(token)
        return ids[0] if len(ids) == 1 else self.eos_token_id

    def tokenize(self, text: str) -> list[int]:
        text = re.sub(r"\s+", " ", text.strip()).lower()
        ids: list[int] = []
        chunks = [text]
        if self.added_tokens:
            # split out added tokens first so they bypass BPE; longest first
            # so a token that prefixes another (<sks> vs <sks>b) cannot
            # shadow it (HF added-token matching is longest-match)
            toks = sorted(self.added_tokens, key=len, reverse=True)
            pat = "(" + "|".join(re.escape(t) for t in toks) + ")"
            chunks = re.split(pat, text)
        for chunk in chunks:
            if chunk in self.added_tokens:
                ids.append(self.added_tokens[chunk])
                continue
            for tok in _PAT.findall(chunk):
                tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
                ids.extend(self.vocab[t] for t in self._bpe(tok).split(" "))
        return ids

    def __call__(self, prompts: List[str] | str, max_length: Optional[int] = None) -> np.ndarray:
        """Tokenize with the reference contract: bos + tokens + eos, truncated
        and padded to model_max_length. Returns (B, max_length) int32."""
        if isinstance(prompts, str):
            prompts = [prompts]
        L = max_length or self.model_max_length
        out = np.full((len(prompts), L), self.pad_token_id, np.int32)
        for i, p in enumerate(prompts):
            ids = [self.bos_token_id] + self.tokenize(p)[: L - 2] + [self.eos_token_id]
            out[i, : len(ids)] = ids
        return out
