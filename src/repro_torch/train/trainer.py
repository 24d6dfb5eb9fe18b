"""Training loop with checkpoint-resume and straggler tracking (port of
repro.train.trainer), on one device.

  * make_train_step: loss -> gradients (autograd through
    transformer.loss_fn) -> clip -> AdamW (train.optim), with gradient
    accumulation over microbatches: the float32 gradients are summed over
    the microbatches in order and divided by their count, and the last
    microbatch's metrics are kept, as the reference's `lax.scan` does;
  * a checkpoint every `checkpoint_every` steps (storage.checkpoint, the
    reference's format), with the data position in `extra`;
  * `fit` resumes from the newest complete checkpoint, and the stream
    resumes at its step (`data_iter_fn(start)`), so a restart neither
    replays nor skips a batch;
  * straggler flagging: a per-step wall-time EWMA and z-score.

The step updates the parameters and the optimizer state in place (the
reference donates their buffers), so `fit` works on a copy of the
caller's model and state. A step's `dt` ends when its metrics are read
as floats, which waits for the device, as `float(v)` does in the
reference.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Callable, Dict, Iterator, Optional

import torch

from ..configs.base import ModelConfig
from ..models import transformer
from ..storage import checkpoint as ckpt_lib
from . import optim


@dataclasses.dataclass
class TrainerConfig:
    opt: optim.AdamWConfig = dataclasses.field(default_factory=optim.AdamWConfig)
    microbatches: int = 1
    checkpoint_every: int = 50
    ckpt_dir: Optional[str] = None
    straggler_zscore: float = 3.0
    straggler_ewma: float = 0.9
    max_step_retries: int = 1


def grads_of(cfg: ModelConfig, params, batch, scan: Optional[bool] = None,
             remat: Optional[bool] = None):
    """Autograd through transformer.loss_fn -> ({name: gradient or None},
    the loss's metrics detached)."""
    named = [(n, p) for n, p in params.named_parameters()
             if p.requires_grad]
    total, metrics = transformer.loss_fn(cfg, params, batch, scan=scan,
                                         remat=remat)
    gs = torch.autograd.grad(total, [p for _, p in named],
                             allow_unused=True)
    return ({n: g for (n, _), g in zip(named, gs)},
            {k: v.detach() for k, v in metrics.items()})


def make_train_step(cfg: ModelConfig, tcfg: TrainerConfig,
                    scan: Optional[bool] = None,
                    remat: Optional[bool] = None,
                    donate: bool = True):
    """-> step(params, opt_state, batch) -> (params, opt_state, metrics),
    metrics {loss, aux, ppl, grad_norm, lr} as 0-d tensors. The step
    always writes in place; `donate` is accepted for the reference's
    signature. Parameters may be DTensors (launch.steps), whose
    accumulators take their placements."""

    def step(params, opt_state, batch):
        k = tcfg.microbatches
        if k > 1:
            acc = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in params.named_parameters()}
            for i in range(k):
                mb = {key: x.reshape((k, x.shape[0] // k)
                                     + tuple(x.shape[1:]))[i]
                      for key, x in batch.items()}
                g, metrics = grads_of(cfg, params, mb, scan, remat)
                for n, gi in g.items():
                    if gi is not None:
                        acc[n].add_(gi)
                del g
            grads = {n: a / k for n, a in acc.items()}
            del acc
        else:
            grads, metrics = grads_of(cfg, params, batch, scan, remat)
        params, opt_state, opt_metrics = optim.update(
            tcfg.opt, grads, opt_state, params)
        return params, opt_state, {**metrics, **opt_metrics}

    return step


@dataclasses.dataclass
class StragglerStats:
    ewma: float = 0.0
    var: float = 0.0
    n: int = 0
    flagged: int = 0

    def observe(self, dt: float, z: float) -> bool:
        if self.n < 3:  # warmup
            self.ewma = dt if self.n == 0 else \
                0.5 * (self.ewma + dt)
            self.n += 1
            return False
        slow = dt > self.ewma + z * max(self.var, 1e-9) ** 0.5 and \
            dt > 1.5 * self.ewma
        d = dt - self.ewma
        self.ewma += 0.1 * d
        self.var = 0.9 * (self.var + 0.1 * d * d)
        self.n += 1
        if slow:
            self.flagged += 1
        return slow


def _copy_state(state: optim.OptState) -> optim.OptState:
    return optim.OptState({n: t.clone() for n, t in state.mu.items()},
                          {n: t.clone() for n, t in state.nu.items()},
                          state.count.clone())


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 scan: Optional[bool] = None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.step_fn = make_train_step(cfg, tcfg, scan=scan)
        self.straggler = StragglerStats()
        self.history: list[Dict[str, float]] = []

    def fit(self, params, data_iter_fn: Callable[[int], Iterator],
            steps: int, opt_state: Optional[optim.OptState] = None):
        """data_iter_fn(start_step) -> iterator of batches (resumable).
        -> (params, opt_state) after `steps` steps in all; the caller's
        model and state are left as they were."""
        tcfg = self.tcfg
        start = 0
        restored = False
        if tcfg.ckpt_dir:
            latest = ckpt_lib.latest_step(tcfg.ckpt_dir)
            if latest is not None:
                tmpl = {"params": params,
                        "opt": opt_state if opt_state is not None
                        else optim.init(params, abstract=True)}
                state, start, _ = ckpt_lib.restore_checkpoint(
                    tcfg.ckpt_dir, tmpl)
                params, opt_state = state["params"], state["opt"]
                restored = True
        if not restored:
            # the step writes in place: work on copies, so the caller's
            # model and state survive (and can seed another run)
            params = copy.deepcopy(params)
            opt_state = _copy_state(opt_state) if opt_state is not None \
                else optim.init(params)

        it = data_iter_fn(start)
        for step in range(start, steps):
            batch = next(it)
            t0 = time.perf_counter()
            params, opt_state, metrics = self.step_fn(
                params, opt_state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            slow = self.straggler.observe(dt, tcfg.straggler_zscore)
            metrics.update(step=step, dt=dt, straggler=int(slow))
            self.history.append(metrics)
            if tcfg.ckpt_dir and (step + 1) % tcfg.checkpoint_every == 0:
                ckpt_lib.save_checkpoint(
                    tcfg.ckpt_dir, step + 1,
                    {"params": params, "opt": opt_state},
                    extra={"data_step": step + 1})
        return params, opt_state
