"""CLIP BPE tokenizer — self-contained, no network.

The reference tokenizes through transformers' CLIPTokenizer inside
``_encode_prompt`` (diffusert/lcm/lcm_controlnet.py:115-160: pad to
max_length 77, truncate, take input_ids).  This is a from-scratch
implementation of the same byte-level BPE algorithm that reads
``vocab.json`` + ``merges.txt`` from a local directory (e.g. a mounted HF
cache); when no vocab is available it degrades to a deterministic
hash-bucket tokenizer so that weightless test/bench runs still produce
stable, well-typed input_ids.
"""

from __future__ import annotations

import functools
import hashlib
import html
import json
import os
import re

import numpy as np

__all__ = ["CLIPTokenizer", "find_vocab_dir"]

_WORD_RE = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|[^\s\w]+",
    re.IGNORECASE,
)


@functools.lru_cache()
def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2 style reversible byte<->unicode map (printable chars only)."""
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
    return dict(zip(bs, map(chr, cs)))


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text)
    return text.strip().lower()


def find_vocab_dir(model_dir: str | None = None) -> str | None:
    """Locate a directory containing vocab.json + merges.txt.

    Searches, in order: the explicit path, $VIDEOSD_VOCAB_DIR, and the HF
    cache layout the reference mounts (docker-compose.yml:8).
    """
    candidates = []
    if model_dir:
        candidates.append(model_dir)
    if os.environ.get("VIDEOSD_VOCAB_DIR"):
        candidates.append(os.environ["VIDEOSD_VOCAB_DIR"])
    hf_home = os.environ.get("HF_HOME", os.path.expanduser("~/.cache/huggingface"))
    hub = os.path.join(hf_home, "hub")
    if os.path.isdir(hub):
        for root, _dirs, files in os.walk(hub):
            if "vocab.json" in files and "merges.txt" in files:
                candidates.append(root)
                break
    for c in candidates:
        if os.path.isfile(os.path.join(c, "vocab.json")) and os.path.isfile(
            os.path.join(c, "merges.txt")
        ):
            return c
    return None


class CLIPTokenizer:
    """Byte-level BPE with CLIP's ``</w>`` end-of-word convention.

    Args:
      vocab_dir: directory with vocab.json/merges.txt, or None for the
        deterministic fallback.
      max_length: context length (77 for all SD text towers).
      pad_to_eos: SD1.x pads with the EOS token; SD2.x pads with id 0
        ("!").  Matches transformers' per-checkpoint pad_token.
    """

    BOT = 49406  # <|startoftext|>
    EOT = 49407  # <|endoftext|>

    def __init__(
        self,
        vocab_dir: str | None = None,
        *,
        max_length: int = 77,
        pad_to_eos: bool = True,
        vocab_size: int = 49408,
    ):
        self.max_length = max_length
        self.vocab_size = vocab_size
        self.byte_encoder = _bytes_to_unicode()
        self.vocab: dict[str, int] | None = None
        self.bpe_ranks: dict[tuple[str, str], int] = {}
        if vocab_dir is not None:
            with open(os.path.join(vocab_dir, "vocab.json"), encoding="utf-8") as f:
                self.vocab = json.load(f)
            with open(os.path.join(vocab_dir, "merges.txt"), encoding="utf-8") as f:
                merges = f.read().split("\n")
            merges = [m for m in merges if m and not m.startswith("#version")]
            self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
            self.vocab_size = len(self.vocab)
        if self.vocab is None and self.vocab_size < 49408:
            # shrunken test vocab: keep specials in range
            self.BOT = self.vocab_size - 2
            self.EOT = self.vocab_size - 1
        self.pad_id = self.EOT if pad_to_eos else 0
        self._bpe_cache: dict[str, tuple[str, ...]] = {}

    @property
    def is_fallback(self) -> bool:
        return self.vocab is None

    # ------------------------------------------------------------- BPE core

    def _bpe(self, token: str) -> tuple[str, ...]:
        if token in self._bpe_cache:
            return self._bpe_cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        self._bpe_cache[token] = word
        return word

    def _encode_word(self, token: str) -> list[int]:
        if self.vocab is not None:
            btoken = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            return [
                self.vocab.get(part, self.vocab.get("<|endoftext|>", self.EOT))
                for part in self._bpe(btoken)
            ]
        # deterministic fallback: stable hash into the non-special id range
        h = int.from_bytes(hashlib.sha256(token.encode()).digest()[:4], "little")
        return [h % (self.vocab_size - 3) + 1]

    # ------------------------------------------------------------- public

    def encode(self, text: str) -> list[int]:
        """Text -> unpadded token ids (no specials)."""
        ids: list[int] = []
        for tok in _WORD_RE.findall(_clean(text)):
            ids.extend(self._encode_word(tok))
        return ids

    def __call__(self, texts: str | list[str]) -> np.ndarray:
        """Texts -> [B, max_length] int32 ids: BOT + tokens + EOT + pad,
        truncating to max_length like the reference's tokenizer call
        (lcm_controlnet.py:134-141)."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), self.max_length), self.pad_id, np.int32)
        for i, text in enumerate(texts):
            ids = self.encode(text)[: self.max_length - 2]
            row = [self.BOT] + ids + [self.EOT]
            out[i, : len(row)] = row
        return out
