"""Port of the JAX package's ``runtime`` modules."""
