"""recall_at_100: over every query answered in the window, the share of the
reference's exact top-100 it returned, ties within 1e-5 x (||q||^2 +
||v||^2) counted as hits (checker.py), averaged over all of them."""


def read(run):
    return run.verdict.recall if run.verdict and run.verdict.answers else None
