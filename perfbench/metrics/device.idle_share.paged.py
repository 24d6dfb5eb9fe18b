"""device.idle_share.paged: percent of the profiled part of a traced window
with nothing running on the device (as device.idle_share), in the paged
cell."""


def read(run):
    return run.trace.idle_share if run.trace is not None else None
