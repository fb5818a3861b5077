"""PyTorch/CUDA port of the `repro` serving stack for NVIDIA Hopper.

The JAX package `repro` is the reference; this package keeps its module
names and public layouts and imports nothing from it. Entry points run on
the card unless the caller passes ``device="cpu"``.
"""
