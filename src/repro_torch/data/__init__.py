"""Synthetic token data (numpy), the JAX package's streams seed for seed."""
