"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention blocks.

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf].  Simplifications noted in DESIGN.md: single
shared block (real model alternates two), no embedding-concat into the
shared block.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="mamba_hybrid",
    n_layers=38, d_model=2048, n_heads=32, kv_heads=32, d_ff=8192,
    vocab=32000, ssm_state=64, ssm_heads=64, ssm_head_dim=64,
    shared_attn_period=6,
)

SMOKE = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, kv_heads=4, d_ff=128, vocab=256,
    ssm_state=16, ssm_heads=4, ssm_head_dim=32, shared_attn_period=2,
    remat=False)
