"""helix_tpu_torch: the PyTorch/CUDA port of helix_tpu for NVIDIA Hopper.

The JAX package ``helix_tpu`` stays the reference.  This package imports
``torch`` and never ``jax`` or anything from ``helix_tpu``; every kernel the
JAX package wrote in Pallas is a hand-written CUDA kernel here
(``csrc/``), built at first use into ``build/helix_tpu_torch/``.
"""
