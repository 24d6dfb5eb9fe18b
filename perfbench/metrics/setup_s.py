"""setup_s: process start to the window's start (import, kernel builds,
data, ingest, build, warm-up)."""


def read(run):
    return run.setup_s
