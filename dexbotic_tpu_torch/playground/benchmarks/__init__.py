"""Benchmark recipes (LIBERO) of the port."""
