"""Host-side CLIP byte-pair-encoding tokenizer (pure Python), a copy of
`difashion_tpu/data/tokenizer.py`. It gives the fixed 77-token `input_ids`
the text encoder takes; the device only sees the [*, 77] int tensors.

Two backends:
  * `CLIPBPETokenizer`: the real CLIP BPE (lowercase, whitespace-collapse, CLIP
    regex, byte-to-unicode alphabet, `</w>` end-of-word merges) over a local
    `vocab.json` + `merges.txt` (an SD checkpoint's tokenizer folder);
  * `HashTokenizer`: a deterministic stand-in for tests and weight-free runs,
    with the same sequence contract (BOS, an id per word, EOS, pad) and ids
    stable across runs.

SD2's tokenizer pads with token id 0 (the OpenCLIP convention); SD1.x pads with
EOS. `pad_token_id` is configurable, default 0.
"""
from __future__ import annotations

import functools
import json
import os
import re
from typing import List, Optional, Sequence

import numpy as np

BOS_ID = 49406
EOS_ID = 49407
MODEL_MAX_LENGTH = 77

# CLIP's word-split regex uses \p{L}/\p{N} (unicode letters / numerals), which
# the stdlib `re` cannot express: use the `regex` module where it is installed,
# else an ASCII equivalent, identical on the ASCII prompts this model builds
# ("A photo of a ...", category names).
try:
    import regex as _regex

    _WORD_RE = _regex.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _regex.IGNORECASE,
    )
except ImportError:  # pragma: no cover
    _WORD_RE = re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-z]+|[0-9]|[^\sa-z0-9]+""",
        re.IGNORECASE,
    )


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


@functools.lru_cache()
def bytes_to_unicode():
    """Reversible byte <-> printable-unicode map (the GPT-2/CLIP alphabet)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class CLIPBPETokenizer:
    """CLIP BPE over a local vocab.json + merges.txt."""

    def __init__(self, vocab_path: str, merges_path: str,
                 pad_token_id: int = 0,
                 model_max_length: int = MODEL_MAX_LENGTH):
        with open(vocab_path) as f:
            self.encoder = json.load(f)
        with open(merges_path, encoding="utf-8") as f:
            merges = f.read().split("\n")
        # first line of merges.txt is a version header
        if merges and merges[0].startswith("#"):
            merges = merges[1:]
        merges = [tuple(m.split()) for m in merges if m and len(m.split()) == 2]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = bytes_to_unicode()
        self.pad_token_id = pad_token_id
        self.model_max_length = model_max_length
        self.bos_id = self.encoder.get("<|startoftext|>", BOS_ID)
        self.eos_id = self.encoder.get("<|endoftext|>", EOS_ID)
        self._cache = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return [token + "</w>"]
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = list(word)
        self._cache[token] = out
        return out

    def _encode_text(self, text: str) -> List[int]:
        text = whitespace_clean(text).lower()
        ids: List[int] = []
        for tok in _WORD_RE.findall(text):
            # special tokens map straight to their ids (HF added-token behavior),
            # never through BPE
            if tok == "<|startoftext|>":
                ids.append(self.bos_id)
                continue
            if tok == "<|endoftext|>":
                ids.append(self.eos_id)
                continue
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok))
        return ids

    def encode(self, text: str) -> List[int]:
        """[BOS] + BPE ids + [EOS], no padding/truncation (HF `input_ids` shape)."""
        return [self.bos_id] + self._encode_text(text) + [self.eos_id]

    def __call__(self, texts: Sequence[str], max_length: Optional[int] = None
                 ) -> np.ndarray:
        """Returns [len(texts), max_length] int32 with BOS ... EOS + pad,
        truncation keeps EOS at the end (HF semantics)."""
        L = max_length or self.model_max_length
        out = np.full((len(texts), L), self.pad_token_id, np.int32)
        for i, text in enumerate(texts):
            ids = [self.bos_id] + self._encode_text(text) + [self.eos_id]
            if len(ids) > L:
                ids = ids[: L - 1] + [self.eos_id]
            out[i, : len(ids)] = ids
        return out


class HashTokenizer:
    """Deterministic stand-in with the CLIP sequence contract (tests / no-weights runs)."""

    def __init__(self, vocab_size: int = 49408, pad_token_id: int = 0,
                 model_max_length: int = MODEL_MAX_LENGTH):
        self.vocab_size = vocab_size
        self.pad_token_id = pad_token_id
        self.model_max_length = model_max_length
        self.bos_id = vocab_size - 2
        self.eos_id = vocab_size - 1

    def _word_id(self, word: str) -> int:
        h = 2166136261
        for ch in word.encode("utf-8"):  # FNV-1a: stable across processes
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        return h % (self.vocab_size - 3) + 1  # avoid 0 (pad) and bos/eos

    def __call__(self, texts: Sequence[str], max_length: Optional[int] = None
                 ) -> np.ndarray:
        L = max_length or self.model_max_length
        out = np.full((len(texts), L), self.pad_token_id, np.int32)
        for i, text in enumerate(texts):
            words = whitespace_clean(text).lower().split(" ")
            ids = [self.bos_id] + [self._word_id(w) for w in words if w] + [self.eos_id]
            if len(ids) > L:
                ids = ids[: L - 1] + [self.eos_id]
            out[i, : len(ids)] = ids
        return out


def load_tokenizer(tokenizer_dir: Optional[str] = None, vocab_size: int = 49408,
                   strict: bool = False):
    """Real BPE if vocab files exist, hash fallback otherwise.

    The fallback is a *stand-in*: its ids have no relation to any trained text
    encoder, so generated images / metric numbers computed through it are
    meaningless. It is fine for tests and throughput runs only — hence the loud
    warning, and `strict=True` (used by the quality-facing CLIs) refuses instead."""
    if tokenizer_dir:
        vocab = os.path.join(tokenizer_dir, "vocab.json")
        merges = os.path.join(tokenizer_dir, "merges.txt")
        if os.path.exists(vocab) and os.path.exists(merges):
            return CLIPBPETokenizer(vocab, merges)
    if strict:
        raise FileNotFoundError(
            f"no CLIP tokenizer vocab at {tokenizer_dir!r} (need vocab.json + "
            "merges.txt, e.g. an SD checkpoint's tokenizer/ folder). Refusing to "
            "fall back to the hash stand-in for a quality-facing run; pass "
            "--allow_random_weights to override."
        )
    import logging

    logging.getLogger("difashion_tpu_torch").warning(
        "tokenizer: no vocab at %r — falling back to HashTokenizer. Ids are a "
        "deterministic stand-in; DO NOT trust generated images or metrics from "
        "this run.", tokenizer_dir,
    )
    return HashTokenizer(vocab_size=vocab_size)
