"""phi3-medium-14b [dense]: 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352 [arXiv:2404.14219] — RoPE SwiGLU GQA.  40 heads do not
divide the 16-way model axis, so attention shards head_dim (DESIGN.md)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, kv_heads=10, d_ff=17920,
    vocab=100352,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=80, n_heads=5, kv_heads=5,
                       d_ff=192, vocab=256, remat=False)
