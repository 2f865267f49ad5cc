"""Port of the JAX package's ``serving`` modules."""
