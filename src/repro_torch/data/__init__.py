"""Port of the JAX package's ``data`` modules."""
