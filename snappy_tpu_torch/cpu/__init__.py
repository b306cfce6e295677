"""Scalar NumPy oracle codec (the API's "cpu" backend)."""
