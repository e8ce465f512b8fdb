"""Synthetic, deterministic data pipeline.

The port of ``repro/training/data.py``, numpy only, so its batches are
bit-identical to the reference's: ``next_batch(step) -> dict of np
arrays`` (host-side), which the launcher moves to the device.  The
stream is a fixed-seed token distribution with a learnable bigram
structure, so small models measurably descend in loss.
"""
from __future__ import annotations

import numpy as np

from ..models.common import ModelConfig


class SyntheticLM:
    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 17):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        rng = np.random.default_rng(seed)
        v = cfg.vocab
        # sparse deterministic bigram: each token has a few likely successors
        self._succ = rng.integers(0, v, size=(v, 4))
        self._seed = seed

    def next_batch(self, step: int) -> dict:
        rng = np.random.default_rng(self._seed + 1000 + step)
        b, s, v = self.batch, self.seq, self.cfg.vocab
        toks = np.empty((b, s), np.int32)
        toks[:, 0] = rng.integers(0, v, size=b)
        choice = rng.integers(0, 4, size=(b, s))
        noise = rng.random((b, s))
        rand_tok = rng.integers(0, v, size=(b, s))
        for t in range(1, s):
            nxt = self._succ[toks[:, t - 1], choice[:, t]]
            toks[:, t] = np.where(noise[:, t] < 0.1, rand_tok[:, t], nxt)
        out = {"tokens": toks}
        if self.cfg.family == "encdec":
            r = np.random.default_rng(self._seed + 2000 + step)
            out["frames"] = r.standard_normal(
                (b, s, self.cfg.d_model)).astype(np.float32)
        if self.cfg.family == "vlm":
            r = np.random.default_rng(self._seed + 3000 + step)
            out["patches"] = r.standard_normal(
                (b, self.cfg.num_patches, 1024)).astype(np.float32)
        return out
