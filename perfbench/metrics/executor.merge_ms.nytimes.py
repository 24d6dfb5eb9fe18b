"""executor.merge_ms.nytimes: executor.merge_ms (the `merge` span, mean host
milliseconds a traced call) in the NYTimes cell, where the rate is not
bounded end to end."""


def read(run):
    return run.span_mean_ms("merge")
