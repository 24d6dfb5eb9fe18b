"""pager.hit_share: percent of partition faults that found their partition
in the frame pool, from the engine's cumulative pager `hits` and `misses`
counters over the whole run (warm-up included)."""
from perfbench import counters


def read(run):
    hits = counters.counter("hits", component="pager")
    misses = counters.counter("misses", component="pager")
    if hits is None or misses is None or hits + misses == 0:
        return None
    return 100.0 * hits / (hits + misses)
