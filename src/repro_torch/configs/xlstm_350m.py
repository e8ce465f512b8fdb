"""xlstm-350m [ssm]: 24L d_model=1024 4H d_ff=0 (blocks carry internal
projections) vocab=50304 [arXiv:2405.04517] — 7:1 mLSTM:sLSTM."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="xlstm",
    n_layers=24, d_model=1024, n_heads=4, kv_heads=4, d_ff=0, vocab=50304,
)

SMOKE = CONFIG.replace(n_layers=3, d_model=64, n_heads=2, kv_heads=2,
                       vocab=256, remat=False)
