"""Retrieval-augmented generation: MicroNN as a first-class LM feature
(port of repro.core.rag).

kNN-LM-style decode: the backbone's last hidden state is the query
vector; the MicroNN index stores (context embedding -> next-token id)
pairs; retrieved neighbour tokens form a distance-weighted distribution
that is interpolated with the LM softmax:

    p(w) = lam * p_knn(w) + (1 - lam) * p_lm(w)

The index is the same updatable IVF structure as everywhere else:
upserts into the datastore are retrievable on the next decode step.
Retrieval runs through executor.run, so on the card it is the K1 scan
(K2 and the float32 rerank on an int8 datastore).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from . import executor
from .query import Q, QuerySpec
from .types import IVFIndex


@dataclasses.dataclass
class RagConfig:
    k: int = 16                  # neighbours per decode step
    n_probe: int = 8
    lam: float = 0.25            # kNN interpolation weight
    temperature: float = 10.0    # distance -> weight

    def spec(self) -> QuerySpec:
        """The retrieval QuerySpec this config denotes (one spec per
        config, the same for every decode step of a session)."""
        return Q.knn(k=self.k, n_probe=self.n_probe)


@dataclasses.dataclass
class RagDatastore:
    """IVF index + neighbour payload (next token per stored vector id)."""
    index: IVFIndex
    # payload token for each asset id; ids index this table directly
    next_token: torch.Tensor     # [max_id] int32


@torch.no_grad()
def knn_logits(ds: RagDatastore, hidden: torch.Tensor, vocab: int,
               cfg: RagConfig, spec: Optional[QuerySpec] = None
               ) -> torch.Tensor:
    """[B, vocab] float32 log-probabilities from the retrieved
    neighbourhood. `spec` overrides the retrieval QuerySpec (a predicate
    over document attributes, a backend pin); defaults to cfg.spec().

    The neighbour weights are added into the vocabulary one neighbour rank
    at a time: within one rank every row adds to one token, so no two
    additions meet and the sums are taken in rank order, the same bits on
    every run and device (no float atomics race)."""
    res = executor.run(ds.index, hidden, spec if spec is not None
                       else cfg.spec())
    ids, scores = res.ids, res.scores
    ok = ids >= 0
    toks = ds.next_token[torch.clamp(ids, min=0).long()].long()   # [B, K]
    w = torch.softmax(torch.where(ok, -scores * cfg.temperature,
                                  torch.full((), -math.inf,
                                             device=scores.device)), dim=-1)
    w = torch.where(ok, w, torch.zeros((), device=w.device))
    b = hidden.shape[0]
    probs = torch.zeros((b, vocab), dtype=torch.float32, device=w.device)
    rows = torch.arange(b, device=w.device)
    for j in range(toks.shape[1]):
        probs.index_put_((rows, toks[:, j]), w[:, j], accumulate=True)
    # guard fully-empty retrievals
    any_ok = ok.any(dim=-1, keepdim=True)
    probs = torch.where(any_ok, probs,
                        torch.full((), 1.0 / vocab, device=probs.device))
    return torch.log(torch.clamp(probs, min=1e-20))


def interpolate(lm_logits: torch.Tensor, knn_logp: torch.Tensor,
                lam: float) -> torch.Tensor:
    """log( lam * p_knn + (1-lam) * p_lm ) computed stably (float32)."""
    lm_logp = torch.log_softmax(lm_logits.float(), dim=-1)
    lam_t = torch.tensor(lam, dtype=torch.float32, device=lm_logp.device)
    return torch.logaddexp(torch.log1p(-lam_t) + lm_logp,
                           torch.log(lam_t) + knn_logp)


@torch.no_grad()
def rag_decode_logits(ds: RagDatastore, lm_logits: torch.Tensor,
                      hidden: torch.Tensor, cfg: RagConfig,
                      spec: Optional[QuerySpec] = None) -> torch.Tensor:
    vocab = lm_logits.shape[-1]
    return interpolate(lm_logits, knn_logits(ds, hidden, vocab, cfg, spec),
                       cfg.lam)
