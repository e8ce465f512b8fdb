"""The LM side stack's models on PyTorch: the decoder-only transformer
(dense and MoE) for serving, with attention and the expert GEMMs on the
hand-written CUDA kernels.  :mod:`.convert` loads the JAX reference's
parameter trees."""
from . import api

__all__ = ["api"]
