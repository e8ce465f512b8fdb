"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) expert
d_ff=512 vocab=49155, MoE 40 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, kv_heads=8, d_ff=512,
    vocab=49155, num_experts=40, top_k=8, expert_d_ff=512,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=48, n_heads=4, kv_heads=2, d_ff=64, vocab=128,
    num_experts=5, top_k=2, expert_d_ff=64, remat=False)
