"""Weight loading from the JAX package's variables."""
