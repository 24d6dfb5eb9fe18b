"""build.kmeans_s: seconds of MicroNN.build()'s `kmeans_fit` and
`kmeans_assign` stages (the mini-batch fit, then the final assignment of
every row through K3), as the program records them."""
from perfbench import buildstages


def read(run):
    return buildstages.sum_of("kmeans_fit", "kmeans_assign")
