"""Shared machinery of the benchmark: finding files by name, clocks and
spans, traffic, weights, the serving and training drivers, the profiled
slice and the comparison that decides ``correct``."""
