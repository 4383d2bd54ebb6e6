"""Semantic specifications (slow, obviously correct) for the kernels."""
