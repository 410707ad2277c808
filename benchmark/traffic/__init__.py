"""Inputs made from the seed: synthetic slices, k-space and weights."""
