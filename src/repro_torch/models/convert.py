"""Parameters between the JAX reference's layout and the port's.

The reference keeps one pytree with layer-stacked leaves (a leading
``L`` axis, consumed by ``lax.scan``) for each stack of like layers:
``blocks`` (the transformer's, internvl2's), ``mamba`` (zamba2's),
``enc`` and ``dec`` (seamless-m4t's); xlstm's ``blocks`` is a Python
list of two kinds of layer, and zamba2's ``shared_attn`` one block.  The
port keeps one dict per layer in a ``ModuleList`` for each stack.
:func:`from_reference` turns the reference's tree, as numpy arrays, into
a model; :func:`numpy_params` makes a tree in the reference's layout
from a numpy seed, with the reference's initialisers' distributions, so
that a test can hand the same arrays to both packages (``jax.random`` and
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
from .transformer import Model, Transformer, _is_moe, tree_map
from .vlm import D_VIT
from .xlstm import _is_slstm

#: how a top-level part of the tree is laid out in the reference: one
#: stack of like layers (leaves with a leading layer axis), a list of
#: per-layer dicts, or one leaf or dict
STACK, LIST, ONE = "stack", "list", "one"


def _attn(cfg: ModelConfig) -> dict:
    """Leaf -> (shape of one layer, fan-in axes or "embed", "ones",
    "zeros", or ("scaled", fan-in axes, factor))."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd
    return {"wq": ((d, h, hd), 0), "wk": ((d, kv, hd), 0),
            "wv": ((d, kv, hd), 0), "wo": ((h, hd, d), (0, 1))}


def _mlp(d: int, f: int) -> dict:
    return {"w_in": ((d, f), 0), "w_gate": ((d, f), 0), "w_out": ((f, d), 0)}


def _block(cfg: ModelConfig) -> dict:
    """A transformer block (``transformer.block_params``)."""
    d = cfg.d_model
    out = {"attn": _attn(cfg), "ln_attn": ((d,), "ones"),
           "ln_mlp": ((d,), "ones")}
    if _is_moe(cfg):
        e, f = cfg.num_experts, cfg.expert_d_ff
        out["moe"] = {"router": ((d, e), 0), "w_in": ((e, d, f), 1),
                      "w_gate": ((e, d, f), 1), "w_out": ((e, f, d), 1)}
    else:
        out["mlp"] = _mlp(d, cfg.d_ff)
    return out


def _ssd(cfg: ModelConfig) -> dict:
    """A Mamba2 layer (``mamba2.ssd_params``)."""
    d, h, n = cfg.d_model, cfg.ssm_heads, cfg.ssm_state
    inner = h * cfg.ssm_head_dim
    return {"w_in": ((d, 2 * inner + 2 * h * n + h), 0),
            "w_out": ((inner, d), 0), "a_log": ((h,), "zeros"),
            "d_skip": ((h,), "ones"), "dt_bias": ((h,), "zeros"),
            "ln": ((d,), "ones")}


def _xlstm_block(cfg: ModelConfig, i: int) -> dict:
    d = cfg.d_model
    if _is_slstm(cfg, i):
        out = {"ln": ((d,), "ones")}
        out.update({f"w_{g}": ((d, d), 0) for g in "ifzo"})
        out.update({f"r_{g}": ((d, d), ("scaled", 0, 0.1)) for g in "ifzo"})
        out["w_down"] = ((d, d), 0)
        return out
    inner, h = 2 * d, cfg.n_heads
    return {"ln": ((d,), "ones"), "w_up": ((d, 2 * inner), 0),
            "w_q": ((inner, inner), 0), "w_k": ((inner, inner), 0),
            "w_v": ((inner, inner), 0), "w_i": ((inner, h), 0),
            "w_f": ((inner, h), 0), "w_down": ((inner, d), 0)}


def _layout(cfg: ModelConfig) -> dict:
    """Top-level key -> (STACK, layers, one layer's spec) | (LIST, [each
    layer's spec]) | (ONE, spec), in the order :func:`numpy_params`
    draws them."""
    d, v = cfg.d_model, cfg.vocab
    embed = (ONE, ((v, d), "embed"))
    ones = (ONE, ((d,), "ones"))
    unembed = (ONE, ((d, v), "embed"))
    if cfg.family == "mamba_hybrid":
        return {"embed": embed, "mamba": (STACK, cfg.n_layers, _ssd(cfg)),
                "shared_attn": (ONE, _block(cfg)), "ln_f": ones,
                "unembed": unembed}
    if cfg.family == "xlstm":
        return {"embed": embed,
                "blocks": (LIST, [_xlstm_block(cfg, i)
                                  for i in range(cfg.n_layers)]),
                "ln_f": ones, "unembed": unembed}
    if cfg.family == "encdec":
        dec = {"self_attn": _attn(cfg), "cross_attn": _attn(cfg),
               "ln_self": ((d,), "ones"), "ln_cross": ((d,), "ones"),
               "ln_mlp": ((d,), "ones"), "mlp": _mlp(d, cfg.d_ff)}
        return {"embed": embed, "enc": (STACK, cfg.enc_layers, _block(cfg)),
                "dec": (STACK, cfg.dec_layers, dec), "ln_enc": ones,
                "ln_dec": ones, "unembed": unembed}
    out = {"embed": embed, "blocks": (STACK, cfg.n_layers, _block(cfg)),
           "ln_f": ones}
    if not cfg.tie_embeddings:
        out["unembed"] = unembed
    if cfg.family == "vlm":
        out["connector"] = (ONE, {"w1": ((D_VIT, d), 0), "w2": ((d, d), 0)})
    return out


def stacked_parts(cfg: ModelConfig) -> tuple:
    """The top-level parts that the reference stacks on a layer axis."""
    return tuple(k for k, (kind, *_) in _layout(cfg).items() if kind == STACK)


def numpy_params(cfg: ModelConfig, seed: int = 0) -> dict:
    """A parameter tree in the reference's layout (float32 numpy arrays,
    stacks of layers on a leading layer axis): dense weights normal with
    std ``1/sqrt(fan_in)`` (sLSTM's recurrent ones times 0.1),
    embeddings with std 0.02, norm scales and ``d_skip`` one, ``a_log``
    and ``dt_bias`` zero, as ``repro.models`` initialises them."""
    rng = np.random.default_rng(seed)

    def make(spec, lead=()):
        if isinstance(spec, dict):
            return {k: make(s, lead) for k, s in spec.items()}
        shape, init = spec
        if init in ("ones", "zeros"):
            return (np.ones if init == "ones" else np.zeros)(
                lead + shape, np.float32)
        x = rng.standard_normal(lead + shape, np.float32)
        if init == "embed":
            return x * np.float32(0.02)
        factor = 1.0
        if isinstance(init, tuple) and init[0] == "scaled":
            _, init, factor = init
        x = x * np.float32(1.0 / np.sqrt(max(1, fan_in(shape, init))))
        return x * np.float32(factor) if factor != 1.0 else x

    tree = {}
    for key, (kind, *rest) in _layout(cfg).items():
        if kind == STACK:
            tree[key] = make(rest[1], (rest[0],))
        elif kind == LIST:
            tree[key] = [make(s) for s in rest[0]]
        else:
            tree[key] = make(rest[0])
    return tree


def empty_params(cfg: ModelConfig, device="meta") -> dict:
    """The port's parameter tree (one dict a layer) of uninitialised
    tensors at ``cfg.param_dtype``, shaped by :func:`_layout`: nothing is
    drawn, and on the ``meta`` device nothing is allocated."""
    def make(spec):
        if isinstance(spec, dict):
            return {k: make(s) for k, s in spec.items()}
        return torch.empty(spec[0], dtype=cfg.param_dtype, device=device)

    tree = {}
    for key, (kind, *rest) in _layout(cfg).items():
        if kind == STACK:
            tree[key] = [make(rest[1]) for _ in range(rest[0])]
        elif kind == LIST:
            tree[key] = [make(s) for s in rest[0]]
        else:
            tree[key] = make(rest[0])
    return tree


def as_model(cfg: ModelConfig, params: dict) -> Model:
    """``params`` (the port's layout) as a model: a :class:`Transformer`
    for ``dense`` and ``moe``, else a :class:`Model`."""
    cls = Transformer if cfg.family in ("dense", "moe") else Model
    return cls(cfg, params)


def _tensor(x, dtype, device):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        device=device, dtype=dtype)


def from_reference(cfg: ModelConfig, tree: dict, device=None, *,
                   keep_master: bool = True) -> Model:
    """The model holding the reference tree's arrays (numpy, stacks of
    layers on a leading axis) at ``cfg.param_dtype`` on ``device``, or
    at ``cfg.dtype`` only when not ``keep_master``: a
    :class:`Transformer` for ``dense`` and ``moe``, else a
    :class:`Model`."""
    pd = cfg.param_dtype if keep_master else cfg.dtype
    leaf = lambda a: _tensor(np.asarray(a), pd, device)
    params = {}
    for key, (kind, *rest) in _layout(cfg).items():
        if key not in tree:
            continue
        if kind == STACK:
            params[key] = [tree_map(lambda a, i=i: leaf(np.asarray(a)[i]),
                                tree[key]) for i in range(rest[0])]
        elif kind == LIST:
            params[key] = [tree_map(leaf, t) for t in tree[key]]
        else:
            params[key] = tree_map(leaf, tree[key])
    return as_model(cfg, params)


def to_reference(tree, cfg: ModelConfig | None = None) -> dict:
    """The port's tree (a model, or a dict like its :meth:`~Model.params`)
    as the reference's layout: float32 numpy arrays, each stack of layers
    on a leading layer axis.  ``cfg`` (a model's own by default) says
    which parts are stacks; without one, every list is (the transformer's
    layout).  A ``None`` leaf (a tensor without a gradient) stays
    ``None``."""
    if isinstance(tree, Model):
        cfg = cfg or tree.cfg
        tree = tree.params()
    layout = _layout(cfg) if cfg is not None else {}

    def leaf(t):
        return None if t is None else \
            t.detach().float().cpu().numpy().copy()

    def stack(layers):
        first = layers[0]
        if isinstance(first, dict):
            return {k: stack([lay[k] for lay in layers]) for k in first}
        got = [leaf(t) for t in layers]
        return None if any(g is None for g in got) else np.stack(got)

    out = {}
    for key, val in tree.items():
        kind = layout.get(key, (STACK if isinstance(val, list) else ONE,))[0]
        if kind == STACK:
            out[key] = stack(val)
        elif kind == LIST:
            out[key] = [tree_map(leaf, t) for t in val]
        else:
            out[key] = tree_map(leaf, val)
    return out
