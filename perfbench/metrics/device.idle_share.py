"""device.idle_share: percent of the profiled part of a traced window in
which no kernel, copy or memset ran on the device (torch.profiler)."""


def read(run):
    return run.trace.idle_share if run.trace is not None else None
