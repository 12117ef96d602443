"""Image-size and logging helpers (copies of the JAX package's)."""
