"""Deterministic, resumable synthetic LM token pipeline (a copy of
repro.data.tokens: numpy only, the same batches bit for bit).

Zipf-distributed tokens with a repeating n-gram structure so a ~100M model
has learnable signal (loss visibly drops in examples/train_lm.py). The
stream is indexed by step -- `iter_from(step)` resumes exactly where a
restored checkpoint left off (data-state is part of fault tolerance).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class TokenStream:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    zipf_a: float = 1.2
    ngram: int = 8

    def _batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        # zipf base stream
        raw = rng.zipf(self.zipf_a, size=(self.batch, self.seq))
        toks = (raw % (self.vocab - 2)) + 2
        # inject learnable n-gram repeats: copy shifted windows
        for b in range(self.batch):
            n_rep = self.seq // (4 * self.ngram)
            src = rng.integers(0, self.seq - 2 * self.ngram, size=n_rep)
            for s in src:
                toks[b, s + self.ngram: s + 2 * self.ngram] = \
                    toks[b, s: s + self.ngram]
        return {"tokens": toks.astype(np.int32)}

    def iter_from(self, step: int) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self._batch_at(step)
            step += 1
