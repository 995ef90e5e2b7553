"""Byte-level text corpus for language modeling (the port's copy of
`tpu_dist.data.text`).

Byte tokens (vocab 256) need no tokenizer, and any file is a corpus.  The
corpus packs the raw bytes into fixed-length, non-overlapping windows and
splits train and validation by windows, deterministically, so every host
computes the same split without communication.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from tpu_dist_torch.data.partition import Partition

VOCAB = 256


class TextCorpus:
    """Fixed-window byte dataset over a text blob: ``corpus[i]`` is the
    ``(seq_len,)`` int32 window ``i`` (stride ``seq_len``)."""

    def __init__(self, text: str | bytes, seq_len: int):
        data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
        if len(data) < seq_len + 1:
            raise ValueError(
                f"corpus of {len(data)} bytes is shorter than one "
                f"window (seq_len={seq_len})"
            )
        self.seq_len = seq_len
        arr = np.frombuffer(data, np.uint8).astype(np.int32)
        n = len(arr) // seq_len
        self._windows = arr[: n * seq_len].reshape(n, seq_len)

    def __len__(self) -> int:
        return len(self._windows)

    def __getitem__(self, i: int):
        return self._windows[i]

    def decode(self, tokens) -> str:
        """Bytes to text (lossy on invalid UTF-8 boundaries)."""
        return bytes(np.asarray(tokens, np.uint8).tolist()).decode("utf-8", errors="replace")


def load_text(path: str | Path, seq_len: int = 256, *, val_fraction: float = 0.0,
              seed: int = 1234):
    """A text file as byte windows.  With ``val_fraction``: ``(train, val)``
    `Partition`s, the windows shuffled by ``random.Random(seed)`` and split,
    the same on every host."""
    corpus = TextCorpus(Path(path).read_bytes(), seq_len)
    if not val_fraction:
        return corpus
    import random

    idx = list(range(len(corpus)))
    random.Random(seed).shuffle(idx)
    n_val = max(1, int(len(idx) * val_fraction))
    if n_val >= len(idx):
        raise ValueError(
            f"corpus has only {len(idx)} window(s) of seq_len={seq_len}; "
            f"a val_fraction={val_fraction} split would leave no training "
            f"windows — use a larger corpus, a shorter seq_len, or val_fraction=0"
        )
    return Partition(corpus, idx[n_val:]), Partition(corpus, idx[:n_val])
