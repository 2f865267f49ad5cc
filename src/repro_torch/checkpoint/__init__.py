"""Port of the JAX package's ``checkpoint`` modules."""
