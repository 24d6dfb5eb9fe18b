"""client.call_p95_ms.nytimes: client.call_p95_ms in the NYTimes cell, where
the rate is not bounded end to end (its own name, since there it moves
another end-to-end metric)."""
from perfbench import yardstick


def read(run):
    got = run.call_ms[run.profiled_calls:]
    return yardstick.percentile(got, 95) if got else None
