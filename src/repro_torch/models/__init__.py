"""The LM side stack's models on PyTorch: the decoder-only transformer
(dense and MoE), zamba2 (Mamba2 with a shared attention block), xLSTM,
the seamless-m4t encoder-decoder and the internvl2 VLM, one API over
them (:mod:`.api`), with attention and the expert GEMMs on the
hand-written CUDA kernels.  :mod:`.convert` loads the JAX reference's
parameter trees."""
from . import api

__all__ = ["api"]
