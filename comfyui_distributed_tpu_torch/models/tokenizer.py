"""Prompt tokenization with ComfyUI-style attention weighting: the
port's own copy of ``comfyui_distributed_tpu/models/tokenizer.py``,
with its textual-inversion splice (:func:`encode_with_embeddings`).

Two backends:
- :class:`BPETokenizer` — real CLIP byte-pair encoding when vocab/merges
  files are present on disk;
- :class:`HashTokenizer` — deterministic fallback mapping words to stable
  hashed ids, used with virtual checkpoints so workflows run end-to-end
  without any downloaded assets.

Both parse the ``(text:1.2)``/``((emphasis))`` weighting syntax ComfyUI's
CLIPTextEncode accepts, returning per-token weights alongside ids.
"""

from __future__ import annotations

import hashlib
import os
import re
from typing import List, Optional, Tuple

import numpy as np

SPECIAL_START = 49406
SPECIAL_END = 49407


def parse_weighted_prompt(text: str) -> List[Tuple[str, float]]:
    """Parse ComfyUI emphasis syntax into (fragment, weight) pairs.

    ``(foo)`` -> 1.1x, ``((foo))`` -> 1.21x, ``[foo]`` -> /1.1,
    ``(foo:1.5)`` -> exactly 1.5.  Unbalanced brackets are treated as
    literal text."""
    out: List[Tuple[str, float]] = []
    stack: List[Tuple[str, float]] = []  # (bracket char, weight at open)
    buf = ""
    cur = 1.0
    i = 0
    explicit_re = re.compile(r":([+-]?\d+(?:\.\d+)?)\)")

    def flush(w: float):
        nonlocal buf
        if buf:
            out.append((buf, w))
            buf = ""

    while i < len(text):
        c = text[i]
        if c == "(":
            flush(cur)
            stack.append(("(", cur))
            cur *= 1.1
            i += 1
        elif c == "[":
            flush(cur)
            stack.append(("[", cur))
            cur /= 1.1
            i += 1
        elif (c == ":" and stack and stack[-1][0] == "("
              and (m := explicit_re.match(text, i))):
            # "(foo:1.5)" — explicit weight replaces the 1.1x default
            base = stack.pop()[1]
            flush(base * float(m.group(1)))
            cur = base
            i = m.end()
        elif c == ")" and stack and stack[-1][0] == "(":
            flush(cur)
            cur = stack.pop()[1]
            i += 1
        elif c == "]" and stack and stack[-1][0] == "[":
            flush(cur)
            cur = stack.pop()[1]
            i += 1
        else:
            buf += c
            i += 1
    flush(cur)  # unbalanced brackets: remaining text keeps its open weight
    return [(t, w) for t, w in out if t.strip()]


class HashTokenizer:
    """Deterministic word-hash tokenizer (no external assets).

    Stable across processes/hosts: ids come from md5 of the lowercased word,
    so distributed participants agree on tokenization without sharing
    files."""

    def __init__(self, vocab_size: int = 49408, max_length: int = 77,
                 pad_with_end: bool = True):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.start = min(SPECIAL_START, vocab_size - 2)
        self.end = min(SPECIAL_END, vocab_size - 1)
        self.pad_id = self.end if pad_with_end else 0

    def _word_id(self, word: str) -> int:
        h = int.from_bytes(hashlib.md5(word.encode()).digest()[:4], "little")
        usable = max(self.start - 1, 1)
        return 1 + (h % (usable - 1))

    def _frag_ids(self, frag: str) -> List[int]:
        return [self._word_id(w)
                for w in re.findall(r"[a-z0-9]+|[^\sa-z0-9]", frag.lower())]

    def encode(self, text: str) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (ids [max_length] int32, weights [max_length] float32)."""
        ids: List[int] = [self.start]
        weights: List[float] = [1.0]
        for frag, w in parse_weighted_prompt(text):
            for wid in self._frag_ids(frag):
                ids.append(wid)
                weights.append(w)
        ids = ids[: self.max_length - 1] + [self.end]
        weights = weights[: self.max_length - 1] + [1.0]
        pad = self.max_length - len(ids)
        ids = ids + [self.pad_id] * pad
        weights = weights + [1.0] * pad
        return (np.asarray(ids, dtype=np.int32),
                np.asarray(weights, dtype=np.float32))


class BPETokenizer:
    """Real CLIP BPE; activates when ``vocab.json`` + ``merges.txt`` exist.

    File format matches openai/CLIP's ``bpe_simple_vocab_16e6``-derived
    assets as shipped by HF tokenizers."""

    def __init__(self, vocab_path: str, merges_path: str,
                 max_length: int = 77, pad_with_end: bool = True):
        import json
        with open(vocab_path, "r", encoding="utf-8") as f:
            self.encoder = json.load(f)
        with open(merges_path, "r", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges
                  if m and not m.startswith("#version")]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.max_length = max_length
        self.start = self.encoder.get("<|startoftext|>", SPECIAL_START)
        self.end = self.encoder.get("<|endoftext|>", SPECIAL_END)
        self.pad_id = self.end if pad_with_end else 0
        self._cache = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        self._cache[token] = list(word)
        return list(word)

    def _frag_ids(self, frag: str) -> List[int]:
        pat = re.compile(r"[a-z0-9]+|[^\sa-z0-9]+")
        out: List[int] = []
        for word in pat.findall(frag.lower()):
            for piece in self._bpe(word):
                out.append(self.encoder.get(
                    piece, self.encoder.get(piece + "</w>", 0)))
        return out

    def encode(self, text: str) -> Tuple[np.ndarray, np.ndarray]:
        ids: List[int] = [self.start]
        weights: List[float] = [1.0]
        for frag, w in parse_weighted_prompt(text):
            for wid in self._frag_ids(frag):
                ids.append(wid)
                weights.append(w)
        ids = ids[: self.max_length - 1] + [self.end]
        weights = weights[: self.max_length - 1] + [1.0]
        pad = self.max_length - len(ids)
        return (np.asarray(ids + [self.pad_id] * pad, dtype=np.int32),
                np.asarray(weights + [1.0] * pad, dtype=np.float32))


EMBEDDING_RE = re.compile(r"embedding:([\w\.\-]+)", re.IGNORECASE)


def has_embedding_refs(text: str) -> bool:
    return bool(EMBEDDING_RE.search(text))


def encode_with_embeddings(tok, text: str, lookup, emb_dim: int):
    """Tokenize with ComfyUI's ``embedding:name`` textual-inversion
    syntax: each reference splices the embedding's vectors into the
    token stream at its place (token id 0 as a placeholder; the CLIP
    tower takes the supplied vector where ``mask`` is set,
    ``models/clip.py``).  Emphasis weights a spliced vector like any
    other token.  ``lookup(name) -> np [K, emb_dim] | None``; a name it
    does not find is dropped with a debug log, as ComfyUI warns and
    skips.  Returns (ids [T] int32, weights [T] f32, override [T,
    emb_dim] f32, mask [T] f32)."""
    from comfyui_distributed_tpu_torch.utils.log import debug_log

    zero = np.zeros((emb_dim,), np.float32)
    ids: List[int] = [tok.start]
    weights: List[float] = [1.0]
    override = [zero]
    mask: List[float] = [0.0]
    for frag, w in parse_weighted_prompt(text):
        # a split on one capture group alternates [text, name, text,
        # name, ...]: the odd pieces are embedding names
        for j, piece in enumerate(EMBEDDING_RE.split(frag)):
            if not piece:
                continue
            if j % 2 == 1:
                vecs = lookup(piece)
                if vecs is None:
                    debug_log(f"textual inversion {piece!r} not found; "
                              "dropping the reference")
                    continue
                for v in np.asarray(vecs, np.float32).reshape(-1, emb_dim):
                    ids.append(0)
                    weights.append(w)
                    override.append(v)
                    mask.append(1.0)
                continue
            for wid in tok._frag_ids(piece):
                ids.append(wid)
                weights.append(w)
                override.append(zero)
                mask.append(0.0)
    T = tok.max_length
    pad = T - min(len(ids), T - 1) - 1
    ids = ids[: T - 1] + [tok.end] + [tok.pad_id] * pad
    weights = weights[: T - 1] + [1.0] + [1.0] * pad
    override = override[: T - 1] + [zero] * (pad + 1)
    mask = mask[: T - 1] + [0.0] * (pad + 1)
    return (np.asarray(ids, np.int32), np.asarray(weights, np.float32),
            np.stack(override).astype(np.float32),
            np.asarray(mask, np.float32))


def make_tokenizer(assets_dir: Optional[str] = None,
                   vocab_size: int = 49408,
                   max_length: int = 77,
                   pad_with_end: bool = True):
    """BPE if assets exist, hash fallback otherwise.  ``pad_with_end``:
    SD1.x/SDXL CLIP pads with EOT; SD2.x OpenCLIP pads with 0."""
    if assets_dir:
        vocab = os.path.join(assets_dir, "vocab.json")
        merges = os.path.join(assets_dir, "merges.txt")
        if os.path.exists(vocab) and os.path.exists(merges):
            return BPETokenizer(vocab, merges, max_length=max_length,
                                pad_with_end=pad_with_end)
    return HashTokenizer(vocab_size=vocab_size, max_length=max_length,
                         pad_with_end=pad_with_end)
