"""delta.flush_ms: mean milliseconds of an inline delta flush (the `flush`
stage of the engine's `stage_s{action="write"}` histograms: a write that
finds the delta full folds it into the partitions first); nothing where no
write filled the delta."""
from perfbench import counters


def read(run):
    return counters.write_stage_ms("flush")
