"""Hand-written CUDA kernels for Hopper, one per Pallas TPU kernel of
the reference that the port's path runs.

Layout per kernel: ``<name>/ops.py`` (the public wrapper: the CUDA
kernel for a CUDA tensor, the plain PyTorch version for a CPU tensor,
never a fallback from one to the other; a launch counter),
``<name>/ref.py`` (the plain PyTorch version, exact on any device), and
the CUDA source ``csrc/<name>.cu``.  :mod:`.fp32` holds the reference's
float32 rules on int32 bit patterns, shared by both plain versions;
:mod:`.build` compiles and loads the CUDA sources.
"""
