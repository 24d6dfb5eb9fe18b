"""executor.merge_ms: the program's `merge` span (the delta epilogue: the
delta's candidates, the merge, dedup and the l2 restore), mean host
milliseconds a traced call."""


def read(run):
    return run.span_mean_ms("merge")
