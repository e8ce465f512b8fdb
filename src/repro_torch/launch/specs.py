"""Meta-device stand-ins and shardings for every (arch x shape) cell: the
port of ``repro/launch/specs.py``.

``build_cell`` returns everything the dry run needs: the port's step
function (``training/steps.py``), abstract arguments and matching
``in_shardings``, with nothing drawn and nothing allocated.  The
abstract arguments are tensors on the ``meta`` device (a model whose
parameter shapes come from ``models.convert._layout``, its AdamW state,
the batch or the decode cache); the shardings are
``sharding.partition.NamedSharding`` trees of the same structure (a
model's is a tree like its ``params()``).  A spec whose axes do not
divide its leaf is refused here, where the reference's ``jit`` refuses
it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from .. import configs
from ..models import api, convert, vlm
from ..models.common import ModelConfig
from ..models.transformer import Model, tree_map
from ..sharding import partition
from ..training import optimizer as opt_mod, steps

ENC_LEN = 4096       # encoder frames for enc-dec decode cells


@dataclasses.dataclass
class Cell:
    arch: str
    shape: configs.ShapeSpec
    cfg: ModelConfig
    step_fn: Callable
    args: tuple                  # abstract args (meta tensor trees)
    in_shardings: tuple
    out_shardings: Any = None    # set when pin_out=True
    donate_argnums: tuple = ()
    model_params_bytes: int = 0  # the parameter count, as the reference's
    notes: str = ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _tree(x):
    """A model as its parameter tree; any other argument as it is."""
    return x.params() if isinstance(x, Model) else x


def param_count(tree) -> int:
    """Elements of every leaf of a parameter tree (or a model)."""
    return sum(math.prod(leaf.shape) for leaf in partition.leaves(_tree(tree)))


def placed_leaves(args, shardings) -> list:
    """(leaf, its NamedSharding or None) for every leaf of ``args`` (a
    tuple like a cell's ``args``), in the order of ``partition.leaves``."""
    out = []
    for a, s in zip(args, shardings):
        got = partition.leaves(_tree(a))
        shs = partition.leaves(s, lambda x: isinstance(
            x, partition.NamedSharding))
        if s is None:
            shs = [None] * len(got)
        if len(got) != len(shs):
            raise ValueError("arguments and shardings differ in structure")
        out += [(t, sh) for t, sh in zip(got, shs) if t is not None]
    return out


def trees(x):
    """A step's arguments or outputs with each model as its parameter
    tree (a tuple stays a tuple, a named tuple a list of its fields)."""
    if isinstance(x, Model):
        return x.params()
    if isinstance(x, (tuple, list)):
        return [trees(v) for v in x]
    if isinstance(x, dict):
        return {k: trees(v) for k, v in x.items()}
    return x


def arg_tensors(args) -> list:
    """Every tensor leaf of a cell's arguments (or of the ``DTensor``
    arguments :func:`distribute` made of them)."""
    return [t for t in partition.leaves(trees(args)) if t is not None]


def distribute(cell: Cell, args: tuple | None = None, local=None) -> tuple:
    """``args`` (by default the cell's own) as ``DTensor``s of the cell's
    ``in_shardings``: a model with ``DTensor`` parameters, every other
    leaf a ``DTensor``.  ``local(leaf, sharding)`` gives this rank's
    shard of each leaf: by default an empty ``meta`` tensor of the
    shard's shape, so nothing is allocated; :func:`slice_local` copies it
    out of whole tensors, as every rank holds them, :func:`view_local`
    views it."""
    if local is None:
        def local(t, sh):
            return torch.empty(partition.local_shape(t.shape, sh.spec,
                                                     sh.mesh),
                               dtype=t.dtype, device="meta")

    def leaf(t, sh):
        if t is None:
            return None
        return partition.from_local(local(t, sh), sh, tuple(t.shape))

    out = []
    for a, s in zip(cell.args if args is None else args, cell.in_shardings):
        if isinstance(a, Model):
            out.append(convert.as_model(cell.cfg, tree_map(leaf, a.params(),
                                                           s)))
        elif a is None:
            out.append(None)
        else:
            out.append(tree_map(leaf, a, s))
    return tuple(out)


def slice_local(t, sh):
    """This rank's shard of whole tensor ``t`` under ``sh``: a copy, so
    that a step that updates its arguments in place leaves ``t`` as it
    was."""
    return t[partition.local_slices(t.shape, sh)].clone(
        memory_format=torch.contiguous_format)


def view_local(t, sh):
    """This rank's shard of whole tensor ``t`` under ``sh``, a view where
    the slice is contiguous (on a one-rank mesh, ``t`` itself: nothing is
    copied)."""
    return t[partition.local_slices(t.shape, sh)].contiguous()


def run_step(cell: Cell, args):
    """The cell's step on ``DTensor`` arguments (:func:`distribute`): the
    port's step function as it is, each operation partitioned by
    DTensor's sharding propagation under the port's rules
    (``partition.register_rules``), and any plain tensor the step makes
    taken as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    partition.register_rules()
    with implicit_replication():
        return cell.step_fn(*args)


def argument_bytes(cell: Cell, index: int | None = None) -> int:
    """One device's bytes of every argument leaf (of argument ``index``
    alone, where given), under the cell's placements (exact: every spec
    divides its leaf)."""
    args, shs = cell.args, cell.in_shardings
    if index is not None:
        args, shs = (args[index],), (shs[index],)
    return sum(partition.local_bytes(t, sh.spec, sh.mesh)
               for t, sh in placed_leaves(args, shs))


def _batch_axes_or_none(rules, mesh, b):
    ax = rules.physical("batch")
    sizes = partition.axis_sizes(mesh)
    total = 1
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        total *= sizes[a]
    return ax if b % total == 0 else None


def train_batch_struct(cfg: ModelConfig, b: int, s: int) -> dict:
    batch = {"tokens": _meta((b, s), torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = _meta((b, s, cfg.d_model), torch.bfloat16)
    if cfg.family == "vlm":
        batch = {"patches": _meta((b, cfg.num_patches, vlm.D_VIT),
                                  torch.bfloat16),
                 "tokens": _meta((b, s - cfg.num_patches), torch.int32)}
    return batch


def _batch_shardings(batch, rules, mesh, b) -> dict:
    ax = _batch_axes_or_none(rules, mesh, b)
    return {k: partition.sharding((ax,) + (None,) * (t.dim() - 1), mesh)
            for k, t in batch.items()}


def _checked(cell: Cell) -> Cell:
    for t, sh in placed_leaves(cell.args, cell.in_shardings):
        partition.local_shape(t.shape, sh.spec, sh.mesh)
    return cell


def build_cell(arch: str, shape_name: str, mesh, *, fsdp: bool = True,
               seq_shard: bool = True, remat: bool | None = None,
               cfg=None, shape=None, enc_len: int | None = None,
               cache_axis: str = "seq", pin_out: bool = False,
               microbatches: int = 1) -> Cell:
    cfg = cfg if cfg is not None else configs.get(arch)
    if remat is not None:
        cfg = cfg.replace(remat=remat)
    shape = shape if shape is not None else configs.SHAPES[shape_name]
    rules = partition.make_rules(cfg, mesh, fsdp=fsdp, seq_shard=seq_shard,
                                 cache_axis=cache_axis)

    specs = api.param_specs(cfg)
    pspec_tree = partition.tree_shardings(specs, rules, mesh)
    model = convert.as_model(cfg, convert.empty_params(cfg))
    n_params = param_count(model)

    if shape.kind == "train":
        ocfg = opt_mod.OptConfig(state_dtype=cfg.param_dtype)
        opt_state = opt_mod.init(dict(model.named_parameters()), ocfg)
        opt_shard = partition.tree_shardings(opt_mod.state_specs(specs),
                                             rules, mesh)
        batch = train_batch_struct(cfg, shape.global_batch, shape.seq_len)
        batch_shard = _batch_shardings(batch, rules, mesh, shape.global_batch)
        settings = steps.TrainSettings(microbatches=microbatches)
        step = steps.make_train_step(cfg, ocfg, settings)
        out_sh = (pspec_tree, opt_shard, None, None) if pin_out else None
        return _checked(Cell(
            arch=arch, shape=shape, cfg=cfg, step_fn=step,
            args=(model, opt_state, batch, None),
            in_shardings=(pspec_tree, opt_shard, batch_shard, None),
            out_shardings=out_sh, donate_argnums=(0, 1),
            model_params_bytes=n_params))

    if shape.kind == "prefill":
        batch = train_batch_struct(cfg, shape.global_batch, shape.seq_len)
        batch_shard = _batch_shardings(batch, rules, mesh, shape.global_batch)
        step = steps.make_prefill_step(cfg, max_len=shape.seq_len)
        return _checked(Cell(arch=arch, shape=shape, cfg=cfg, step_fn=step,
                             args=(model, batch),
                             in_shardings=(pspec_tree, batch_shard),
                             model_params_bytes=n_params))

    # decode
    b = shape.global_batch
    bax = _batch_axes_or_none(rules, mesh, b)
    if bax is None:  # tiny batches (long_500k B=1): replicate the batch dim
        rules = dataclasses.replace(rules, mapping=tuple(
            (k, None if k == "batch" else v) for k, v in rules.mapping))
    cache = api.init_cache(cfg, b, max_len=shape.seq_len, device="meta",
                           enc_len=enc_len or ENC_LEN)
    cache_shard = partition.tree_shardings(api.cache_specs(cfg), rules, mesh)
    vec = partition.sharding((bax,), mesh)
    token = _meta((b,), torch.int32)
    lengths = _meta((b,), torch.int32)
    active = _meta((b,), torch.int32)
    step = steps.make_serve_decode_step(cfg)
    out_sh = (None, cache_shard, vec) if pin_out else None
    return _checked(Cell(arch=arch, shape=shape, cfg=cfg, step_fn=step,
                         args=(model, cache, token, lengths, active),
                         in_shardings=(pspec_tree, cache_shard, vec, vec,
                                       vec),
                         out_shardings=out_sh, donate_argnums=(1,),
                         model_params_bytes=n_params))
