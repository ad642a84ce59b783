"""Experiment recipes, examples, the success-rate harness and the SO-101
bridge of the port, as the repository's playground/ and hardware/ hold the
JAX package's."""
