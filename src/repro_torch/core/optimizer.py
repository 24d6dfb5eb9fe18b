"""Hybrid query optimizer (paper §3.5.1, Eqs. 1-3; port of
repro.core.optimizer).

Chooses between:
  * pre-filtering  -- evaluate the predicate, brute-force over the
                      qualifying rows (100% recall; cost ~ the predicate's
                      cardinality)
  * post-filtering -- ANN scan with the predicate masked before the top-k
                      (cost ~ n_probe * p_target; recall can drop for
                      highly selective predicates)

Decision rule: pre-filter iff  F_hat_filters < F_hat_IVF  where
F_hat_IVF = n_probe * p_target / |R|   (Eq. 2).

Both arms are QuerySpec rewrites run by core/executor.py: `plan_spec`
resolves `hybrid="auto"` into a concrete "pre" spec (with a sized gather
cap) or "post" spec. The selectivity estimates are host float64 numpy
(core/hybrid.AttributeStats), so the decisions and caps equal the JAX
package's on the same index.

`plan_spec` counts its decisions in the cumulative `plans{plan="pre"}` and
`plans{plan="post"}` counters of the optimizer's metrics scope (the engine
passes its `component=planner` scope, so a rebuilt optimizer keeps the
series).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..obs import metrics as obs_metrics
from . import executor
from .hybrid import AttributeStats, Node
from .query import Q, QuerySpec, ResultSet
from .types import IVFIndex


@dataclasses.dataclass
class PlanDecision:
    plan: str                  # "pre" | "post"
    f_filters: float           # estimated predicate selectivity factor
    f_ivf: float               # IVF pseudo-predicate selectivity factor
    prefilter_cap: int         # gather budget when plan == "pre"


class HybridOptimizer:
    """Plan chooser + executor. The engine rebuilds it from fresh stats
    after build() and recover()."""

    def __init__(self, stats: AttributeStats, *,
                 cap_safety: float = 2.0, cap_round: int = 256,
                 max_prefilter_cap: Optional[int] = None, metrics=None):
        self.stats = stats
        self.cap_safety = cap_safety
        self.cap_round = cap_round
        self.max_prefilter_cap = max_prefilter_cap
        if metrics is None:
            metrics = obs_metrics.default_registry().scope(
                component="planner", inst=obs_metrics.next_instance())
        self._c_plans = {p: metrics.counter("plans", plan=p)
                         for p in ("pre", "post")}

    def choose(self, index: IVFIndex, predicate: Node,
               n_probe: int) -> PlanDecision:
        """Eq. 2, and the gather cap: est * cap_safety + cap_round, clipped
        to the live rows and max_prefilter_cap, rounded up to cap_round."""
        n_rows = max(1, int(index.num_live()))
        f_filters = self.stats.selectivity_factor(predicate)
        f_ivf = min(1.0, n_probe * index.config.target_partition_size
                    / n_rows)
        est_rows = f_filters * n_rows
        cap = int(est_rows * self.cap_safety) + self.cap_round
        cap = min(cap, n_rows, *([self.max_prefilter_cap]
                                 if self.max_prefilter_cap else []))
        cap = max(self.cap_round, -(-cap // self.cap_round) * self.cap_round)
        plan = "pre" if f_filters < f_ivf else "post"
        return PlanDecision(plan=plan, f_filters=f_filters, f_ivf=f_ivf,
                            prefilter_cap=cap)

    def plan_spec(self, index: IVFIndex, spec: QuerySpec
                  ) -> Tuple[QuerySpec, PlanDecision]:
        """Resolve a hybrid spec into a concrete one: "pre" vs "post" for
        `hybrid='auto'` (Eq. 2), and the pre-filter cap where the caller
        left it open. Equal specs resolve to equal specs while the stats
        stand."""
        tree = spec.predicate_tree
        if tree is None:
            raise ValueError(
                "plan_spec needs an inspectable predicate tree (a "
                "hand-written filter callable has no selectivity estimate)")
        decision = self.choose(index, tree, spec.n_probe)
        plan = decision.plan if spec.hybrid == "auto" else spec.hybrid
        if plan == "pre":
            cap = spec.cap if spec.cap is not None else decision.prefilter_cap
            out = spec.prefilter(cap)
        else:
            out = spec.postfilter()
        self._c_plans[plan].inc()
        return out, dataclasses.replace(decision, plan=plan)

    def execute(self, index: IVFIndex, queries, predicate: Node, k: int,
                n_probe: int, force_plan: Optional[str] = None,
                use_mqo: bool = False, backend: Optional[str] = None
                ) -> Tuple[ResultSet, PlanDecision]:
        """Kwarg shim over the spec path (`use_mqo` is kept for the
        reference's signature: an ANN spec is the MQO plan)."""
        del use_mqo
        spec = Q.knn(k=k, n_probe=n_probe).where(predicate).backend(backend)
        if force_plan is not None:
            spec = dataclasses.replace(spec, hybrid=force_plan)
        spec, decision = self.plan_spec(index, spec)
        return executor.run(index, queries, spec), decision
