"""Workload entry points: the experiment CLIs."""
