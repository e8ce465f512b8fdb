"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4, head_dim 128)
expert d_ff=768 vocab=151936, MoE 128 experts top-8
[hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, kv_heads=4, head_dim=128,
    d_ff=768, vocab=151936, num_experts=128, top_k=8, expert_d_ff=768,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, kv_heads=2, head_dim=16, d_ff=96,
    vocab=256, num_experts=8, top_k=2, expert_d_ff=96, remat=False)
