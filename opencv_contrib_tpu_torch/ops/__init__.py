"""Sampling, filters and integral images; ops.cuda holds the hand-written kernels."""
