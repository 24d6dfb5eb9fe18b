"""executor.rerank_ms: the program's `rerank` span (the int8 tier's exact
float32 rerank of the scan's candidates), mean host milliseconds a traced
call."""


def read(run):
    return run.span_mean_ms("rerank")
