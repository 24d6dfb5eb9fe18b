"""queries_per_s: query vectors answered in the window over the window's
seconds (host clock; the window closes when its last call's answer is in
host memory)."""


def read(run):
    return run.queries / run.window_s if run.window_s > 0 else None
