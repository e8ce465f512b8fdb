"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256 [arXiv:2407.21783].

Scale notes: bf16 params + bf16 optimizer state (ZeRO over the data axis)
is what fits 256 x 16GB v5e; fp32-master is possible at 512 chips.  See
EXPERIMENTS.md #Dry-run memory analysis.
"""
import torch
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, kv_heads=8, d_ff=53248,
    vocab=128256, param_dtype=torch.bfloat16,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=128, n_heads=8, kv_heads=2,
                       d_ff=384, vocab=512, param_dtype=torch.float32,
                       remat=False)
