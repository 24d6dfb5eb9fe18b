"""executor.probe_ms.nytimes: executor.probe_ms (the `probe` span, mean
milliseconds a traced call) in the NYTimes cell, where the rate is not
bounded end to end."""


def read(run):
    return run.span_mean_ms("probe")
