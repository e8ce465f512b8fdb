"""internvl2-2b [vlm]: InternViT (stub) + InternLM2-1.8B backbone:
24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553
[arXiv:2404.16821; hf].  num_patches=1024 precomputed patch embeddings."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, kv_heads=8, d_ff=8192,
    vocab=92553, num_patches=1024,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, kv_heads=2,
                       d_ff=128, vocab=256, num_patches=8, remat=False)
