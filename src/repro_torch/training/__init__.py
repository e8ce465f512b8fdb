"""Training and serving steps of the port: AdamW, int8 gradient
compression, the synthetic data stream, checkpoints and the step
builders."""
from . import optimizer, steps, data, checkpoint, compression  # noqa: F401
