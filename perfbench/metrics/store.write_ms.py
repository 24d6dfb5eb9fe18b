"""store.write_ms: mean milliseconds of a write batch's durable commit (a
session's one SQLite transaction: the `commit` stage of the engine's
`stage_s{action="write"}` histograms)."""
from perfbench import counters


def read(run):
    return counters.write_stage_ms("commit")
