"""pager.fault_ms: the program's `pager_fault` span (the frame pool's
faults of a call's probe chunks: hits, and misses read from SQLite or
taken from the read-ahead, written to the card), mean host milliseconds a
traced call."""


def read(run):
    return run.span_mean_ms("pager_fault")
