"""Microbenchmarks of the port on the GPU (perf/kernelbench.py)."""
