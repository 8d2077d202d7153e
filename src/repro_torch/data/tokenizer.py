"""A byte-level tokenizer (self-contained, deterministic)."""

from __future__ import annotations

import numpy as np


class ByteTokenizer:
    """UTF-8 bytes and three specials: vocab = 256 + 3 (pad, bos, eos)."""

    PAD, BOS, EOS = 256, 257, 258
    vocab_size = 259

    def encode(self, text: str, bos: bool = True, eos: bool = False) -> np.ndarray:
        ids = list(text.encode("utf-8"))
        if bos:
            ids = [self.BOS] + ids
        if eos:
            ids = ids + [self.EOS]
        return np.asarray(ids, dtype=np.int32)

    def decode(self, ids) -> str:
        b = bytes(int(i) for i in ids if int(i) < 256)
        return b.decode("utf-8", errors="replace")
