"""Launchers (port of repro.launch): serve.py, train.py; the mesh
(mesh.py), the step builders (steps.py), the cost model (costs.py) and
the dry-run (dryrun.py)."""
