"""Torch ops: norms, rope, dense, attention and the paged kernels."""
