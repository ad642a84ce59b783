"""Experiment recipes of the port, as the repository's playground/ holds the JAX package's."""
