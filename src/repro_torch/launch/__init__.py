"""Port of the JAX package's ``launch`` modules."""
