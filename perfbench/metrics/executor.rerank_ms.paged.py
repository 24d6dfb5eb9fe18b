"""executor.rerank_ms.paged: the program's `rerank` span in the paged cell
(_rerank_from_store: the candidates' float32 rows gathered from SQLite and
rescored), mean host milliseconds a traced call."""


def read(run):
    return run.span_mean_ms("rerank")
