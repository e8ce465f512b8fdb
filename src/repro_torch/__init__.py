"""The eGPU soft-GPGPU simulator on PyTorch and CUDA (Hopper).

A port of the JAX package ``repro`` that keeps its layout and public
names and matches it bit for bit on every ``MachineState`` leaf.  It
imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.
Entry points run on the card (``device="cuda"``) and raise without one,
unless the caller passes ``device="cpu"``.
"""
