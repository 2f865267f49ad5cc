"""Port of the JAX package's ``training`` modules."""
