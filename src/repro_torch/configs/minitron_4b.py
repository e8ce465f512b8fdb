"""minitron-4b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000 [arXiv:2407.14679; hf] — pruned nemotron.  24 heads do not
divide the 16-way model axis -> head_dim sharding."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, kv_heads=8, d_ff=9216,
    vocab=256000,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=96, n_heads=6, kv_heads=2,
                       d_ff=256, vocab=512, remat=False)
