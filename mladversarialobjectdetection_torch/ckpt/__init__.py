"""Weight bridge from the JAX package's Flax variables."""
