"""Utilities: state and weight interop with the JAX package."""
