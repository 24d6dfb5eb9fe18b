"""Batched serving engine with continuous batching + optional RAG (port
of repro.serving.engine).

A fixed pool of batch slots; finished sequences are swapped for queued
prompts (continuous batching) -- slot state lives in the cache's batch
dimension. The RAG hook wires MicroNN in as a first-class serving
feature: each decode step's hidden state queries the datastore and the
kNN distribution interpolates into the LM logits (core/rag.py). Because
the datastore is the updatable MicroNN index, documents upserted while
serving become retrievable on the next step.

The reference's semantics are kept, quirks included: a prompt is fed one
token at a time through a full-batch decode step whose cache updates are
kept for the admitted slot only (`_step_slot`); every decode step uses one
position, the largest of the live slots' (`step`); `run()` returns an
empty list. The port's decode writes the cache in place, so `_step_slot`
saves what the step will write -- a ring entry's slot at the step's
position, a recurrent state whole -- and puts the other slots' back,
which keeps exactly slot s's update, as the reference's copy does.
Whisper's encoder K/V (`xk`, `xv`) are never written by decode and stay
as `_reset_slot` leaves them (zero, as the reference's fresh cache).

One reference defect is not carried over: the reference's `_reset_slot`
/ `_step_slot` slice every cache leaf on axis 1, which is the batch only
for stacked entries; on a tail entry (batch on axis 0: recurrentgemma's
two trailing RG-LRU layers) they write column s of every slot's state.
Here each entry is sliced on its own batch dim (1 stacked, 0 tail), so
every slot keeps its own state.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from functools import partial
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.query import QuerySpec
from ..core.rag import RagConfig, RagDatastore, rag_decode_logits
from ..core.types import resolve_device
from ..models import decode as decode_lib


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: int = -1          # -1: run to max_new_tokens
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """`params` is the model (models.init_model or
    convert.params_from_arrays); `device` None means the card."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 s_max: int = 256, rag: Optional[RagDatastore] = None,
                 rag_cfg: Optional[RagConfig] = None,
                 rag_spec: Optional[QuerySpec] = None, device=None):
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.slots = slots
        self.s_max = s_max
        self.rag = rag
        self.rag_cfg = rag_cfg or RagConfig()
        # the retrieval QuerySpec every decode step issues; pass a custom
        # spec to e.g. fuse an attribute predicate over the datastore
        self.rag_spec = rag_spec if rag_spec is not None \
            else self.rag_cfg.spec()
        self.queue: deque[Request] = deque()
        self.active: List[Optional[Request]] = [None] * slots
        self.cache = decode_lib.init_cache(cfg, slots, s_max,
                                           device=self.device)
        self.slot_pos = np.zeros(slots, np.int64)
        self.slot_tok = np.zeros((slots, 1), np.int32)
        # slot_tok's copy on the device, kept equal to it (_admit, step)
        self._toks_dev = torch.zeros((slots, 1), dtype=torch.int32,
                                     device=self.device)
        self._decode = partial(self._decode_impl, cfg)

    @staticmethod
    def _decode_impl(cfg, params, cache, token, pos):
        return decode_lib.decode_step(cfg, params, cache, token, pos)

    # -- client API ----------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                req = self.queue.popleft()
                self.active[s] = req
                # prefill the slot token by token (slot-local, as in the
                # reference; the parallel path is models.decode.prefill)
                self._reset_slot(s)
                for t, tok in enumerate(req.prompt[:-1]):
                    self._step_slot(s, tok, t)
                self.slot_tok[s, 0] = req.prompt[-1]
                self._toks_dev[s, 0] = int(req.prompt[-1])
                self.slot_pos[s] = len(req.prompt) - 1

    def _caches(self):
        """Every layer cache dict, with its batch dim (1 in a stacked
        entry, 0 in a tail entry)."""
        for name, c in self.cache.items():
            yield c, 1 if name.startswith("p") else 0

    def _reset_slot(self, s: int):
        for c, bd in self._caches():
            for key, t in c.items():
                t.select(bd, s).fill_(-1 if key == "pos" else 0)

    def _step_slot(self, s: int, tok: int, pos: int):
        """Feed one prompt token through slot s only: the full batch runs,
        and the other slots' entries that it writes are put back -- a
        ring's slot at `pos`, a recurrent state whole. Nothing here waits
        for the device: the batch's tokens are formed on it, and the
        entries go back by whole-slice copies."""
        saved = []
        for c, bd in self._caches():
            saved.append({key: view.clone()
                          for key, view in self._written(c, bd, pos)})
        toks = self._toks_dev.clone()
        toks[s, 0] = tok
        self._decode(self.params, self.cache, toks, pos)
        for (c, bd), old in zip(self._caches(), saved):
            for key, view in self._written(c, bd, pos):
                old[key].select(bd, s).copy_(view.select(bd, s))
                view.copy_(old[key])

    @staticmethod
    def _written(c, bd: int, pos: int):
        """(key, view) of what one decode step at `pos` writes in the
        layer cache c: a ring's entries at slot pos % W, a recurrent
        state's every entry (not the encoder's xk / xv)."""
        if "pos" in c:
            w = c["pos"].shape[bd + 1]
            for key in decode_lib.RING_KEYS:
                yield key, c[key].select(bd + 1, pos % w)
        else:
            yield from c.items()

    # -- decode loop ----------------------------------------------------------
    @torch.no_grad()
    def step(self) -> Dict[int, int]:
        """One decode step for all active slots. -> {uid: new_token}. No
        autograd graph is built (the model's parameters are trainable)."""
        self._admit()
        live = [s for s, r in enumerate(self.active) if r is not None]
        if not live:
            return {}
        pos = int(max(self.slot_pos[s] for s in live))
        logits, hidden, self.cache = self._decode(
            self.params, self.cache, self._toks_dev, pos)
        if self.rag is not None:
            logits = rag_decode_logits(self.rag, logits, hidden,
                                       self.rag_cfg, spec=self.rag_spec)
        toks = torch.argmax(logits, dim=-1).cpu().numpy()
        out = {}
        for s in live:
            req = self.active[s]
            tok = int(toks[s])
            req.out.append(tok)
            out[req.uid] = tok
            self.slot_tok[s, 0] = tok
            self.slot_pos[s] += 1
            if tok == req.eos_id or len(req.out) >= req.max_new_tokens:
                req.done = True
                self.active[s] = None
        self._toks_dev.copy_(torch.from_numpy(self.slot_tok))
        return out

    def run(self, max_steps: int = 64) -> List[Request]:
        """Step until the queue and the slots are empty or max_steps; the
        returned list stays empty, as in the reference (read each
        Request's `out` and `done`)."""
        finished: List[Request] = []
        for _ in range(max_steps):
            if not self.queue and all(r is None for r in self.active):
                break
            self.step()
        return finished
