"""engine.build_s: host seconds of MicroNN.build() in set-up, until the
device has finished."""


def read(run):
    return run.setup.get("build_s")
