"""seamless-m4t-large-v2 [audio, enc-dec]: 24L enc + 24L dec,
d_model=1024 16H (kv=16) d_ff=8192 vocab=256206 [arXiv:2308.11596; hf].

The speech frontend is a STUB per the assignment: input_specs provides
precomputed frame embeddings (B, S, 1024).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=48, enc_layers=24, dec_layers=24,
    d_model=1024, n_heads=16, kv_heads=16, d_ff=8192, vocab=256206,
)

SMOKE = CONFIG.replace(n_layers=4, enc_layers=2, dec_layers=2, d_model=64,
                       n_heads=4, kv_heads=4, d_ff=128, vocab=256,
                       remat=False)
