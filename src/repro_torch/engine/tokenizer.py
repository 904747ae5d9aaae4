"""Deterministic hash tokenizer: whitespace word-piece with stable ids.

Identical text → identical token ids, so template prefixes shared across a
relQuery's requests produce genuinely shared token-block prefixes — exactly
what the prefix cache and the DPU's utok estimate need to be exercised for
real. (No learned merges; this is a serving-system reproduction, not an NLP
one.)
"""
from __future__ import annotations

import hashlib
from typing import List, Sequence


class HashTokenizer:
    def __init__(self, vocab_size: int = 50_000, bos: int = 1, eos: int = 0):
        self.vocab_size = vocab_size
        self.bos = bos
        self.eos = eos

    def _tok(self, word: str) -> int:
        h = int.from_bytes(hashlib.blake2s(word.encode(), digest_size=4).digest(), "little")
        return 2 + h % (self.vocab_size - 2)

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        toks = [self._tok(w) for w in text.split()]
        return ([self.bos] + toks) if add_bos else toks

    def decode(self, ids: Sequence[int]) -> str:
        return " ".join(f"<{i}>" for i in ids)
