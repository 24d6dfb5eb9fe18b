"""device.idle_share.nytimes: device.idle_share (percent of the profiled
part of a traced window with nothing running on the device) in the NYTimes
cell, where the rate is not bounded end to end."""


def read(run):
    return run.trace.idle_share if run.trace is not None else None
