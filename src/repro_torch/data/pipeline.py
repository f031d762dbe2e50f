"""LM data pipeline: byte-level tokenizer, synthetic corpus generator,
packed next-token batches (used by train_4k and the training example)."""
from __future__ import annotations

import dataclasses
from typing import Iterator, List

import numpy as np


class ByteTokenizer:
    """Byte tokenizer with BOS=0 / EOS=1 (ids shifted by 2)."""
    bos = 0
    eos = 1

    def __init__(self, vocab_size: int = 258):
        self.vocab_size = max(vocab_size, 258)

    def encode(self, text: str) -> List[int]:
        return [self.bos] + [b + 2 for b in text.encode("utf-8")] + [self.eos]

    def decode(self, ids: List[int]) -> str:
        return bytes(i - 2 for i in ids
                     if i >= 2 and i - 2 < 256).decode("utf-8", "replace")


def synthetic_corpus(n_docs: int = 256, seed: int = 0) -> List[str]:
    """Deterministic pseudo-text with learnable structure (repeated
    patterns + arithmetic snippets) so a 100M model's loss visibly drops."""
    rng = np.random.default_rng(seed)
    words = ["the", "model", "serves", "tokens", "prefill", "decode",
             "cache", "batch", "goodput", "latency", "macro", "instance",
             "tensor", "pipeline", "schedule", "roll", "activate"]
    docs = []
    for _ in range(n_docs):
        n = int(rng.integers(30, 120))
        seq = rng.choice(words, size=n)
        a, b = rng.integers(1, 50, 2)
        docs.append(" ".join(seq) + f" {a}+{b}={a + b}.")
    return docs


@dataclasses.dataclass
class TokenDataset:
    """Packs tokenized documents into fixed-length next-token batches."""
    tokens: np.ndarray          # 1-D stream

    @staticmethod
    def from_texts(texts: List[str],
                   tok: ByteTokenizer = ByteTokenizer()) -> "TokenDataset":
        stream: List[int] = []
        for t in texts:
            stream.extend(tok.encode(t))
        return TokenDataset(np.asarray(stream, np.int32))

    def batches(self, batch_size: int, seq_len: int,
                seed: int = 0) -> Iterator[dict]:
        rng = np.random.default_rng(seed)
        n = len(self.tokens) - seq_len - 1
        while True:
            starts = rng.integers(0, n, batch_size)
            toks = np.stack([self.tokens[s:s + seq_len] for s in starts])
            labs = np.stack(
                [self.tokens[s + 1:s + seq_len + 1] for s in starts])
            yield {"tokens": toks, "labels": labs}
