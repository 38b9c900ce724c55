"""Hopper kernels of the port, their plain versions and the dispatch policy."""
