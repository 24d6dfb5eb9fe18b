"""build.load_s: seconds of MicroNN.build()'s `load` stage (the rows and
their attributes read from SQLite), as the program records it."""
from perfbench import buildstages


def read(run):
    return buildstages.sum_of("load")
