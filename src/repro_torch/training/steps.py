"""Train and serve step builders: the port of ``repro/training/steps.py``.

Distributed-optimization features, all config-gated, as the reference's:

* microbatch gradient accumulation with *drop-stale-microbatch*
  straggler mitigation: a keep-mask zeroes the contributions of
  microbatches flagged as stragglers, rescaling by the kept count;
* gradient compression (int8 + error feedback);
* the non-finite sentinel: the update, the step count included, is
  skipped (parameters and optimizer state keep their values) when the
  loss or the gradient norm is non-finite, and ``finite`` reports it so
  the driver can restore from a checkpoint.

The training step keeps the reference's signature, ``train_step(params,
opt_state, batch, ef_residual) -> (params, opt_state, ef_residual,
metrics)``, with a :class:`~repro_torch.models.transformer.Transformer`
as ``params``: it is updated in place, leaf by leaf, and returned, as are
the optimizer state and the residual (see :mod:`.optimizer` for why).
The gradients run through the hand-written kernels' backward (attention
and the expert GEMMs) on the card, their plain versions on the CPU.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models import api, convert
from ..models.transformer import tree_map
from ..models.common import ModelConfig
from . import compression, optimizer as opt_mod


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    microbatches: int = 1
    compress_grads: bool = False
    #: read by no code, here or in the reference's ``TrainSettings``;
    #: kept so that the two dataclasses take the same fields
    straggler_mitigation: bool = False


def make_train_step(cfg: ModelConfig, ocfg: opt_mod.OptConfig,
                    settings: TrainSettings = TrainSettings()):
    """Returns train_step(model, opt_state, batch, ef_residual) ->
    (model, opt_state, ef_residual, metrics); ``batch`` holds tensors on
    the model's device."""

    def grads_of(model, batch):
        """(loss, {name: gradient}): the parameters' ``.grad`` handed over
        (and cleared), so that each can be freed once applied."""
        params = dict(model.named_parameters())
        mb = settings.microbatches
        if mb <= 1:
            loss = api.loss(cfg, model, batch)
            loss.backward()
            loss = loss.detach()
        else:
            keep = batch.get("microbatch_keep")
            dev = batch["tokens"].device
            if keep is None:
                keep = torch.ones((mb,), dtype=torch.float32, device=dev)
            keep = keep.float()
            total = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(mb):
                part = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])[i]
                        for k, v in batch.items() if k != "microbatch_keep"}
                lm = api.loss(cfg, model, part).float()
                (keep[i] * lm).backward()
                total = total + keep[i] * lm.detach()
            denom = torch.clamp(torch.sum(keep), min=1.0)
            loss = total / denom
            with torch.no_grad():
                for p in params.values():
                    if p.grad is not None:
                        p.grad.div_(denom)
        grads = {}
        for name, p in params.items():
            grads[name] = p.grad if p.grad is not None \
                else torch.zeros_like(p)
            p.grad = None
        return loss, grads

    stacked = convert.stacked_parts(cfg)

    def train_step(model, opt_state, batch, ef_residual):
        model.requires_grad_()
        loss, grads = grads_of(model, batch)
        if settings.compress_grads:
            grads, ef_residual = compression.apply_error_feedback(
                grads, ef_residual)
        _, opt_state, info = opt_mod.apply(dict(model.named_parameters()),
                                           grads, opt_state, ocfg, loss=loss,
                                           stacked=stacked)
        metrics = {"loss": loss, "grad_norm": info["grad_norm"],
                   "lr": info["lr"], "finite": info["finite"].float()}
        return model, opt_state, ef_residual, metrics

    return train_step


def make_serve_decode_step(cfg: ModelConfig, mask_cache: bool = False):
    """decode_step(model, cache, token, lengths, active): ``active`` is the
    per-request dynamic-wavefront mask; finished or empty slots keep
    their lengths frozen.

    ``mask_cache=False`` (default): only ``lengths`` are masked.  An
    inactive slot still writes its k/v at its frozen position, a row that
    is never read before the slot is prefilled again, and its recurrent
    state (zamba2's SSM state, xlstm's) still advances, as in the
    reference.
    ``mask_cache=True`` keeps an inactive slot's cache as it was, by the
    reference's merge of every cache leaf whose first, or else second,
    axis is the batch: the port writes a KV cache in place, so the cache
    is copied before the step.
    """

    def merge(new, old, keep):
        if new.shape == old.shape and new.dim() >= 1 \
                and old.shape[0] == keep.shape[0]:
            shape = (keep.shape[0],) + (1,) * (new.dim() - 1)
        elif new.dim() >= 2 and new.shape[1] == keep.shape[0]:
            shape = (1, keep.shape[0]) + (1,) * (new.dim() - 2)
        else:
            return new
        return torch.where(keep.reshape(shape), new, old)

    def step(model, cache, token, lengths, active):
        keep = active.bool()
        old = tree_map(torch.clone, cache) if mask_cache else None
        logits, new_cache, new_lengths = api.decode(cfg, model, cache, token,
                                                    lengths)
        if mask_cache:
            new_cache = tree_map(lambda n, o: merge(n, o, keep), new_cache,
                                 old)
        new_lengths = torch.where(keep, new_lengths, lengths)
        return logits, new_cache, new_lengths

    return step


def make_prefill_step(cfg: ModelConfig, max_len: int):
    def step(model, batch):
        return api.prefill(cfg, model, batch, max_len)
    return step
