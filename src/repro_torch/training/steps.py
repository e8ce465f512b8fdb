"""Serving steps: the port of ``make_serve_decode_step`` and
``make_prefill_step`` (``repro/training/steps.py``).  The training steps
wait for the backward kernels (ROADMAP.md, queue 1, item 11)."""
from __future__ import annotations

import torch

from ..models import api
from ..models.common import ModelConfig


def make_serve_decode_step(cfg: ModelConfig, mask_cache: bool = False):
    """decode_step(model, cache, token, lengths, active): ``active`` is the
    per-request dynamic-wavefront mask; finished or empty slots keep
    their lengths frozen.

    ``mask_cache=False`` (default): only ``lengths`` are masked.  An
    inactive slot still writes its k/v at its frozen position, a row that
    is never read before the slot is prefilled again.
    ``mask_cache=True`` leaves an inactive slot's cache as it was: the
    port writes the cache in place, so the one row per layer that the
    step overwrites is saved first and put back for inactive slots.
    """

    def step(model, cache, token, lengths, active):
        keep = active.bool()
        if mask_cache:
            rows = torch.arange(lengths.shape[0], device=lengths.device)
            pos = lengths.long().clamp(0, cache.k.shape[3] - 1)
            old_k = cache.k[:, rows, :, pos].clone()     # (B, L, KV, hd)
            old_v = cache.v[:, rows, :, pos].clone()
        logits, new_cache, new_lengths = api.decode(cfg, model, cache, token,
                                                    lengths)
        if mask_cache:
            drop = ~keep
            for c, old in ((new_cache.k, old_k), (new_cache.v, old_v)):
                cur = c[:, rows, :, pos]
                c[:, rows, :, pos] = torch.where(drop[:, None, None, None],
                                                 old, cur)
        new_lengths = torch.where(keep, new_lengths, lengths)
        return logits, new_cache, new_lengths

    return step


def make_prefill_step(cfg: ModelConfig, max_len: int):
    def step(model, batch):
        return api.prefill(cfg, model, batch, max_len)
    return step
