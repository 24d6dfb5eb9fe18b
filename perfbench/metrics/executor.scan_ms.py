"""executor.scan_ms: the program's `scan` span
(MicroNN.query(..., trace=True)), mean milliseconds a traced call."""


def read(run):
    return run.span_mean_ms("scan")
