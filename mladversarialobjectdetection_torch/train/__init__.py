"""Supervised detector training (the port of the JAX package's `train/`)."""
