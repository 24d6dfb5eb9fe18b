"""store.ingest_s: host seconds of the set-up's ingest, the configuration's
rows handed to MicroNN.upsert in upserts of `ingest_rows`."""


def read(run):
    return run.setup.get("ingest_s")
