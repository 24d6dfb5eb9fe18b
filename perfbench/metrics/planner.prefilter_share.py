"""planner.prefilter_share: percent of the hybrid planner's decisions
(HybridOptimizer.plan_spec, the engine's `plans{component="planner"}`
counters, warm-up included) that chose the pre-filter plan; nothing where
the planner decided no call (none carried a predicate)."""
from perfbench import counters


def read(run):
    pre = counters.counter("plans", component="planner", plan="pre")
    post = counters.counter("plans", component="planner", plan="post")
    if pre is None or post is None or pre + post == 0:
        return None
    return 100.0 * pre / (pre + post)
