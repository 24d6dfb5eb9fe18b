"""client.call_p95_ms: the 95th percentile over the query calls of a traced
window's spans part (the calls after the profiled part), on the host clock,
from the call until its ids and scores are in host memory. The program's
spans are on in those calls, so the tail reads a little above an untraced
run's."""
from perfbench import yardstick


def read(run):
    got = run.call_ms[run.profiled_calls:]
    return yardstick.percentile(got, 95) if got else None
