"""Hand-written CUDA kernels for Hopper, one per Pallas TPU kernel of
the reference that the port's path runs.

Layout per kernel: ``<name>/ops.py`` (the public wrapper: the CUDA
kernel for a CUDA tensor, the plain PyTorch version for a CPU tensor
(and for a ``meta`` one, which computes nothing: ``build.plain``),
never a fallback from one to the other; a launch counter),
``<name>/ref.py`` (the plain PyTorch version, exact on any device), and
the CUDA source ``csrc/<name>.cu``.  An eGPU kernel's source holds two
routes: ``step``, a whole FP or DOT/SUM instruction step in place on
the register file (the main path; :mod:`.egpu_step` holds their shared
host side), and ``tile``, the TPU kernel's function.  An LM kernel's
source holds several kernels, one per route, and its ``ops.route``
picks one by an explicit rule; ``csrc/hopper.cuh`` and
``hopper_wgmma.cuh`` hold their TMA, ``mbarrier`` and ``wgmma`` PTX.
:mod:`.fp32` holds the reference's float32 rules on int32 bit patterns,
shared by the eGPU kernels' plain versions; :mod:`.build` compiles and
loads the CUDA sources.
"""
