"""Synthetic vector workloads."""
