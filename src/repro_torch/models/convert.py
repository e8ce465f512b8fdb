"""Parameters between the JAX reference's layout and the port's.

The reference keeps one pytree with layer-stacked block leaves (a
leading ``L`` axis, consumed by ``lax.scan``); the port keeps one dict
per layer in a ``ModuleList``.  :func:`from_reference` turns the
reference's tree, as numpy arrays, into a :class:`Transformer`;
:func:`numpy_params` makes a tree in the reference's layout from a numpy
seed, with the reference's initialisers' distributions, so that a test
can hand the same arrays to both packages (``jax.random`` and
``torch.Generator`` give different numbers for one seed) and the card,
which has no JAX, can rebuild the arrays a reference run used.
:func:`to_reference` is the inverse of :func:`from_reference`: the
port's tree (parameters, or gradients of the same layout) as the
reference's numpy tree.
"""
from __future__ import annotations

import numpy as np
import torch

from .common import ModelConfig, fan_in
from .transformer import Transformer, _is_moe


def _shapes(cfg: ModelConfig) -> dict:
    """Leaf -> (shape of one layer, fan-in axes or "embed" or "ones")."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd
    out = {"attn": {"wq": ((d, h, hd), 0), "wk": ((d, kv, hd), 0),
                    "wv": ((d, kv, hd), 0), "wo": ((h, hd, d), (0, 1))},
           "ln_attn": ((d,), "ones"), "ln_mlp": ((d,), "ones")}
    if _is_moe(cfg):
        e, f = cfg.num_experts, cfg.expert_d_ff
        out["moe"] = {"router": ((d, e), 0), "w_in": ((e, d, f), 1),
                      "w_gate": ((e, d, f), 1), "w_out": ((e, f, d), 1)}
    else:
        f = cfg.d_ff
        out["mlp"] = {"w_in": ((d, f), 0), "w_gate": ((d, f), 0),
                      "w_out": ((f, d), 0)}
    return out


def numpy_params(cfg: ModelConfig, seed: int = 0) -> dict:
    """A parameter tree in the reference's layout (float32 numpy arrays,
    block leaves stacked on a leading layer axis): dense weights normal
    with std ``1/sqrt(fan_in)``, embeddings with std 0.02, norm scales
    one, as ``repro.models`` initialises them."""
    rng = np.random.default_rng(seed)
    n = cfg.n_layers

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        shape, init = spec
        if init == "ones":
            return np.ones((n,) + shape, np.float32)
        std = 1.0 / np.sqrt(max(1, fan_in(shape, init)))
        return (rng.standard_normal((n,) + shape, np.float32)
                * np.float32(std))

    tree = {"embed": (rng.standard_normal((cfg.vocab, cfg.d_model),
                                          np.float32) * np.float32(0.02)),
            "blocks": make(_shapes(cfg)),
            "ln_f": np.ones((cfg.d_model,), np.float32)}
    if not cfg.tie_embeddings:
        tree["unembed"] = (rng.standard_normal((cfg.d_model, cfg.vocab),
                                               np.float32) * np.float32(0.02))
    return tree


def _tensor(x, dtype, device):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        device=device, dtype=dtype)


def from_reference(cfg: ModelConfig, tree: dict, device=None, *,
                   keep_master: bool = True) -> Transformer:
    """A :class:`Transformer` holding the reference tree's arrays (numpy,
    layer-stacked block leaves) at ``cfg.param_dtype`` on ``device``, or
    at ``cfg.dtype`` only when not ``keep_master``."""
    pd = cfg.param_dtype if keep_master else cfg.dtype

    def layer(t, i):
        if isinstance(t, dict):
            return {k: layer(v, i) for k, v in t.items()}
        return _tensor(np.asarray(t)[i], pd, device)

    blocks = [layer(tree["blocks"], i) for i in range(cfg.n_layers)]
    params = {k: _tensor(np.asarray(tree[k]), pd, device)
              for k in ("embed", "ln_f", "unembed") if k in tree}
    params["blocks"] = blocks
    return Transformer(cfg, params)


def to_reference(tree) -> dict:
    """The port's tree (a :class:`Transformer`, or a dict like its
    :meth:`~Transformer.params`: one dict per layer in ``"blocks"``) as
    the reference's layout: float32 numpy arrays, block leaves stacked on
    a leading layer axis.  A ``None`` leaf (a tensor without a gradient)
    stays ``None``."""
    if isinstance(tree, Transformer):
        tree = tree.params()

    def leaf(t):
        return None if t is None else \
            t.detach().float().cpu().numpy().copy()

    def stack(layers):
        first = layers[0]
        if isinstance(first, dict):
            return {k: stack([lay[k] for lay in layers]) for k in first}
        got = [leaf(t) for t in layers]
        return None if any(g is None for g in got) else np.stack(got)

    out = {k: leaf(v) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = stack(tree["blocks"])
    return out
