"""store.read_kb_per_query: KiB the store read from SQLite on the query
path (the engine's cumulative `bytes_read{component="store"}`: the pager's
partition fetches, read-ahead included, and the rerank's row gathers) per
query vector answered. The counter covers every query call of the run
(warm-up included), so the vectors are the engine's query calls times the
window's mean call size (every call of the mix has one size)."""
from perfbench import counters


def read(run):
    nbytes = counters.counter("bytes_read", component="store")
    calls = counters.counter("queries", component="engine")
    answered = len(run.call_ms)
    if nbytes is None or not calls or not answered:
        return None
    return nbytes / 1024.0 / (calls * run.queries / answered)
