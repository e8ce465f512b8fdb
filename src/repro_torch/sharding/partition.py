"""Logical-axis -> mesh spec resolution, and the specs' placement on a
``torch.distributed`` device mesh.

The port of ``repro/sharding/partition.py``.  Models annotate every
parameter and cache leaf with *logical* axis names (see
``models/common.py``); :func:`make_rules` resolves them against a mesh
with the reference's per-architecture divisibility fallbacks:

* attention shards **heads** when both H and KV divide the model axis,
  the q heads alone when only H does, nothing when H does not (phi3's
  40 heads, minitron's and granite's 24): the FFN carries the model axis;
* MoE shards **experts** when E divides, otherwise the per-expert ffn
  dim (granite: 40 experts -> shard expert_d_ff = 512);
* **vocab** is replicated when it does not divide (granite 49155,
  seamless 256206, internvl2 92553 are not multiples of 16);
* **fsdp** (ZeRO) shards the d_model dim of weights over the data axis
  when enabled and d_model divides it;
* **batch** spans ("pod", "data") on the multi-pod mesh;
* KV caches shard **seq**, or **cache_heads** when asked and the KV heads
  divide.

The rules are framework-free: a mesh is anything with axis names and a
shape, the reference tests' duck type (``axis_names``, ``devices.shape``)
or a ``torch.distributed.device_mesh.DeviceMesh`` (``mesh_dim_names``,
``shape``).  A resolved spec is a plain tuple with one entry per tensor
dim, each a mesh axis name, a tuple of names or ``None``, as
``jax.sharding.PartitionSpec`` holds them.  :func:`tree_shardings` maps
specs onto a real ``DeviceMesh`` (:class:`NamedSharding`: a
``torch.distributed.tensor`` placement per mesh dim, ``Shard(tensor
dim)`` or ``Replicate()``), and :func:`place` puts a whole tensor there
as a ``DTensor``, each rank slicing its own shard, with no collective.
A spec whose axes do not divide a dim is refused (:func:`local_shape`),
never placed unevenly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..models.common import ModelConfig
from ..models.transformer import tree_map


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Resolved logical->physical map for one (cfg, mesh) pair."""
    mapping: tuple           # tuple of (logical, physical) pairs

    def physical(self, logical):
        return dict(self.mapping).get(logical)


def axis_sizes(mesh) -> dict:
    """Mesh axis name -> size, in mesh order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _axis(mesh, name: str) -> int:
    return axis_sizes(mesh)[name]


def make_rules(cfg: ModelConfig, mesh, *, fsdp: bool = True,
               seq_shard: bool = True, cache_axis: str = "seq") -> ShardingRules:
    m = _axis(mesh, "model")
    d = _axis(mesh, "data")
    has_pod = "pod" in axis_sizes(mesh)
    batch_axes = ("pod", "data") if has_pod else ("data",)

    # The attention ladder:
    #  1. q+kv heads shard when both divide the model axis;
    #  2. q heads only when kv does not divide (kv params replicated):
    #     sharding head_dim instead would all-reduce the full (B,H,S,T)
    #     logits tensor;
    #  3. attention replicated when q heads do not divide either
    #     (phi3 40H, minitron/granite 24H): the FFN carries the model axis.
    q_ok = cfg.n_heads % m == 0
    kv_ok = cfg.kv_heads % m == 0
    attn_q = "model" if q_ok else None
    attn_kv = "model" if (q_ok and kv_ok) else None
    attn_hd = None

    experts_ok = cfg.num_experts and cfg.num_experts % m == 0
    expert_ff_ok = cfg.expert_d_ff and cfg.expert_d_ff % m == 0

    mapping = {
        "batch": batch_axes,
        "fsdp": "data" if (fsdp and cfg.d_model % d == 0) else None,
        "heads": attn_q,
        "kv_heads": attn_kv,
        "hd": attn_hd,
        "ff": "model",   # every assigned arch's ffn/inner dims divide by 16
        "heads2": None,  # xlstm inner->inner projections: input dim already
                         # carries the "ff" model sharding

        "vocab": "model" if cfg.vocab % m == 0 else None,
        "experts": "model" if experts_ok else None,
        "expert_ff": None if experts_ok else ("model" if expert_ff_ok else None),
        "seq": "model" if (seq_shard and cache_axis == "seq") else None,
        "cache_heads": "model" if (cache_axis == "heads"
                                   and cfg.kv_heads % m == 0) else None,
        "layers": None,
        None: None,
    }
    return ShardingRules(mapping=tuple(mapping.items()))


def is_pspec(x) -> bool:
    """A resolved spec: a plain tuple of axis names, tuples of names and
    ``None``s."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, str) or (isinstance(e, tuple) and all(
            isinstance(a, str) for a in e)) for e in x)


def leaves(tree, is_leaf=lambda x: False) -> list:
    """The leaves of a tree of dicts (by sorted key, as ``jax.tree`` and
    ``training.checkpoint`` order them), lists and tuples."""
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v, is_leaf)]
    return [tree]


def _entry(axes):
    """One dim's mesh axes as ``PartitionSpec`` holds them: a tuple of one
    name is that name."""
    return axes[0] if isinstance(axes, tuple) and len(axes) == 1 else axes


def to_pspec(spec_tuple, rules: ShardingRules) -> tuple:
    """One logical tuple -> the resolved spec."""
    return tuple(_entry(rules.physical(logical)) for logical in spec_tuple)


def tree_pspecs(spec_tree, rules: ShardingRules):
    return tree_map(lambda s: to_pspec(s, rules), spec_tree)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A resolved spec on a ``DeviceMesh``: ``placements`` holds one
    ``Shard(tensor dim)`` or ``Replicate()`` per mesh dim."""
    mesh: Any
    spec: tuple
    placements: tuple


def placements(pspec: tuple, mesh) -> tuple:
    """The ``torch.distributed.tensor`` placements of a resolved spec: a
    mesh dim named in the spec at tensor dim ``j`` is ``Shard(j)``, any
    other ``Replicate()``.  A dim over several mesh axes (``("pod",
    "data")``) is sharded in mesh order, as ``DTensor`` shards it, so the
    axes must be named in that order."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(pspec):
        if entry is None:
            continue
        idx = [names.index(a)
               for a in (entry if isinstance(entry, tuple) else (entry,))]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} shards two dims "
                                 f"of {pspec!r}")
            out[i] = Shard(dim)
    return tuple(out)


def sharding(pspec: tuple, mesh) -> NamedSharding:
    pspec = tuple(_entry(e) for e in pspec)
    return NamedSharding(mesh, pspec, placements(pspec, mesh))


def tree_shardings(spec_tree, rules: ShardingRules, mesh):
    """Each logical spec of ``spec_tree`` resolved and placed on ``mesh``
    (a ``DeviceMesh``) as a :class:`NamedSharding`."""
    return tree_map(lambda s: sharding(to_pspec(s, rules), mesh), spec_tree)


def batch_pspec(rules: ShardingRules, ndim: int) -> tuple:
    """Data batches: leading dim over the batch axes, rest replicated."""
    return (_entry(rules.physical("batch")),) + (None,) * (ndim - 1)


def check_divisibility(shape, pspec: tuple, mesh) -> bool:
    sizes = axis_sizes(mesh)
    for dim, ax in zip(shape, tuple(pspec) + (None,) * (len(shape) - len(pspec))):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        total = 1
        for a in axes:
            total *= sizes[a]
        if dim % total:
            return False
    return True


def local_shape(shape, pspec: tuple, mesh) -> tuple:
    """The shape of one device's shard; raises ``ValueError`` where the
    spec's axes do not divide a dim (the reference's ``jit`` refuses such
    an argument sharding too)."""
    if len(pspec) > len(shape) or not check_divisibility(shape, pspec, mesh):
        raise ValueError(f"shape {tuple(shape)} is not divisible by spec "
                         f"{pspec!r} on mesh {axis_sizes(mesh)}")
    sizes = axis_sizes(mesh)
    out = list(shape)
    for dim, ax in enumerate(pspec):
        for a in () if ax is None else (ax if isinstance(ax, tuple) else (ax,)):
            out[dim] //= sizes[a]
    return tuple(out)


def local_bytes(t, pspec: tuple, mesh) -> int:
    """Bytes of one device's shard of tensor ``t`` (any device, ``meta``
    included) under ``pspec``."""
    return math.prod(local_shape(t.shape, pspec, mesh)) * t.element_size()


def local_slices(shape, sh: NamedSharding) -> tuple:
    """This rank's shard of a whole array of ``shape`` under ``sh``: one
    slice per dim (a dim over several mesh axes is split outer axis
    first, as ``DTensor`` splits it)."""
    from torch.distributed.tensor import Shard
    coord = sh.mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the sharding's mesh")
    sizes = list(axis_sizes(sh.mesh).values())
    lshape = local_shape(shape, sh.spec, sh.mesh)
    out = []
    for dim in range(len(shape)):
        idx = 0
        for i, p in enumerate(sh.placements):
            if isinstance(p, Shard) and p.dim == dim:
                idx = idx * sizes[i] + coord[i]
        out.append(slice(idx * lshape[dim], (idx + 1) * lshape[dim]))
    return tuple(out)


def from_local(local, sh, shape):
    """The ``DTensor`` of global ``shape`` whose shard on this rank is
    ``local`` (the caller's own tensor, not copied), placed as ``sh``: a
    :class:`NamedSharding` or a ``(mesh, placements)`` pair."""
    from torch.distributed.tensor import DTensor
    mesh, place = (sh.mesh, sh.placements) if isinstance(sh, NamedSharding) \
        else sh
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, place, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def redistributed(t, place, local: bool = False):
    """``DTensor`` ``t`` redistributed to placements ``place`` where it is
    placed otherwise (a collective only then); its local shard where
    ``local``."""
    if list(t.placements) != list(place):
        t = t.redistribute(t.device_mesh, place)
    return t.to_local() if local else t


def place(t, sh: NamedSharding):
    """Whole tensor ``t`` as a ``DTensor`` under ``sh``: this rank's slice
    of it, a view where that slice is contiguous (the whole tensor on a
    one-rank mesh), so no memory beyond the tensor's own is taken."""
    local = t[local_slices(t.shape, sh)]
    return from_local(local.contiguous(), sh, tuple(t.shape))


def placed_bytes(t) -> int:
    """Bytes of this rank's shard of ``t``: a ``DTensor``'s local tensor,
    a plain tensor whole (0 for ``None``)."""
    if t is None:
        return 0
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.to_local()
    return t.numel() * t.element_size()


def register_rules() -> None:
    """The port's ``DTensor`` sharding rules (idempotent): the
    hand-written kernels' operators (each ``ops.register_dtensor_rules``)
    and an elementwise rule for each operator of :data:`POINTWISE`."""
    from ..kernels.flash_attention import ops as aops
    from ..kernels.wavefront_matmul import ops as mops
    aops.register_dtensor_rules()
    mops.register_dtensor_rules()
    if _RULES:
        return
    from torch.distributed.tensor.experimental import register_sharding
    for name in POINTWISE:
        op = getattr(torch.ops.aten, name).default
        register_sharding(op)(_pointwise(len(op._schema.returns)))
    _RULES.append(True)


def _pointwise(n_out: int):
    """The rule of an elementwise operator whose tensor operands and
    ``n_out`` outputs all have one shape: all sharded alike on any one
    dim, or all replicated."""
    from torch.distributed.tensor import Replicate, Shard

    def rule(*args, **kwargs):
        ts = [hasattr(a, "tensor_meta") for a in args]
        ndim = next(a.ndim for a, t in zip(args, ts) if t)
        out = []
        for p in [Replicate()] + [Shard(i) for i in range(ndim)]:
            out.append(([p] * n_out, [p if t else None for t in ts]))
        return out
    return rule


#: elementwise operators DTensor has no rule for (the backward of
#: ``softplus``, the SSD's step size, and the mLSTM's ``logsigmoid``)
POINTWISE = ("softplus_backward", "log_sigmoid_forward",
             "log_sigmoid_backward")
_RULES: list = []
