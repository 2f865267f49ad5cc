"""Port of the JAX package's ``core`` modules."""
