"""Launchers (port of repro.launch): serve.py, train.py."""
