"""client.queries_per_s: query vectors answered in a traced window's spans
part (the calls after the profiled part) over that part's seconds, on the
host clock, until the last call's answer is in host memory. The per-layer
reading of the rate in a cell whose rate spreads too widely from run to run
to be bounded end to end; the program's spans are on in those calls, so it
reads a little below an untraced window's rate."""


def read(run):
    return run.spans_queries / run.spans_s if run.spans_s > 0 else None
