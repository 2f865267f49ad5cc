"""Port of the JAX package's ``models`` modules."""
