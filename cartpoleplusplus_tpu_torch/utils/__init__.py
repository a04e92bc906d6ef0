"""Utilities: parameter conversion from the JAX package's flax trees."""
