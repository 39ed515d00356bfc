"""Tensor operators: math, RNG, sampling, intersection, traversal, BSDF."""
