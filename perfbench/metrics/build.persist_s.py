"""build.persist_s: seconds of MicroNN.build()'s `codes` stage (the int8
code tier written to SQLite; int8 only) and `partitions` stage (every row's
partition and the centroids written to SQLite), as the program records
them."""
from perfbench import buildstages


def read(run):
    return buildstages.sum_of("codes", "partitions")
