"""The port's partition rules (``repro_torch.sharding.partition``) and the
models' mesh specs against the JAX reference's, with no devices.

* the ports of ``tests/test_sharding.py``'s tests: the attention ladder,
  the expert and vocab fallbacks, multi-pod batch axes, every
  architecture's parameter and cache specs divisible on the production
  ``FakeMesh``es, and the oversubscribed mesh refused with the port's
  recipe;
* for every architecture x {16x16, 2x16x16} x fsdp {on, off} x cache
  axis {seq, heads}: the port's resolved parameter, cache and
  optimizer-state specs equal the reference's ``tree_pspecs`` leaf for
  leaf, once the reference's layer stacks are split as
  ``models.convert`` splits them (a stacked leaf's spec without its
  leading ``"layers"`` entry, one a layer), and one device's bytes of
  every leaf agree (a stacked leaf's are its layers' together).
"""
import functools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec as P  # noqa: E402

import repro.configs as C  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.sharding import partition as rpart  # noqa: E402
from repro.training import optimizer as ropt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import api as tapi, convert  # noqa: E402
from repro_torch.sharding import partition  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


class FakeMesh:
    """Just enough of a Mesh for rule resolution (no devices)."""
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


SINGLE = FakeMesh((16, 16), ("data", "model"))
MULTI = FakeMesh((2, 16, 16), ("pod", "data", "model"))
MESHES = pytest.mark.parametrize("mesh", [SINGLE, MULTI],
                                 ids=["16x16", "2x16x16"])


def _rules(arch, mesh, **kw):
    return partition.make_rules(tconfigs.get(arch), mesh, **kw)


# -- the ports of tests/test_sharding.py ------------------------------------

def test_attention_sharding_ladder():
    # phi3: 40 heads % 16 != 0 -> attention replicated (FFN carries TP)
    r = _rules("phi3-medium-14b", SINGLE)
    assert r.physical("heads") is None
    assert r.physical("hd") is None
    # llama3: 128 q-heads divide but kv=8 does not -> q-heads only
    r = _rules("llama3-405b", SINGLE)
    assert r.physical("heads") == "model" and r.physical("kv_heads") is None
    # zamba2: 32/32 heads divide -> full head sharding
    r = _rules("zamba2-1p2b", SINGLE)
    assert r.physical("heads") == "model"
    assert r.physical("kv_heads") == "model"


def test_expert_fallback():
    r = _rules("qwen3-moe-30b-a3b", SINGLE)
    assert r.physical("experts") == "model"       # 128 % 16 == 0
    assert r.physical("expert_ff") is None
    r = _rules("granite-moe-3b-a800m", SINGLE)
    assert r.physical("experts") is None          # 40 % 16 != 0
    assert r.physical("expert_ff") == "model"     # 512 % 16 == 0


def test_vocab_fallback():
    assert _rules("yi-9b", SINGLE).physical("vocab") == "model"
    for arch in ("granite-moe-3b-a800m", "seamless-m4t-large-v2",
                 "internvl2-2b"):
        assert _rules(arch, SINGLE).physical("vocab") is None


def test_batch_axes_multi_pod():
    r = _rules("yi-9b", MULTI)
    assert r.physical("batch") == ("pod", "data")
    assert partition.batch_pspec(r, 3) == (("pod", "data"), None, None)
    r = _rules("yi-9b", SINGLE)
    assert r.physical("batch") == ("data",)
    # as PartitionSpec holds it: a tuple of one axis is that axis
    assert partition.batch_pspec(r, 2) == tuple(rpart.batch_pspec(
        rpart.make_rules(C.get("yi-9b"), SINGLE), 2)) == ("data", None)


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
@MESHES
def test_param_specs_divisible_for_all_archs(arch, mesh):
    """Every parameter leaf's spec must divide its shape on the production
    mesh, the property that makes the dry run's placements exact."""
    cfg = tconfigs.get(arch)
    rules = partition.make_rules(cfg, mesh)
    pspecs = partition.tree_pspecs(tapi.param_specs(cfg), rules)
    flat_specs = partition.leaves(pspecs, partition.is_pspec)
    flat_shapes = partition.leaves(convert.empty_params(cfg))
    assert len(flat_specs) == len(flat_shapes)
    for spec, leaf in zip(flat_specs, flat_shapes):
        assert partition.check_divisibility(leaf.shape, spec, mesh), \
            f"{arch}: {tuple(leaf.shape)} not divisible by {spec}"


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_cache_specs_divisible(arch):
    cfg = tconfigs.get(arch)
    rules = partition.make_rules(cfg, SINGLE)
    cspecs = partition.tree_pspecs(tapi.cache_specs(cfg), rules)
    cache = tapi.init_cache(cfg, 128, max_len=32768, device="meta",
                            enc_len=4096)
    flat_specs = partition.leaves(cspecs, partition.is_pspec)
    flat = partition.leaves(cache)
    assert len(flat_specs) == len(flat)
    for spec, leaf in zip(flat_specs, flat):
        assert partition.check_divisibility(leaf.shape, spec, SINGLE), \
            f"{arch}: cache {tuple(leaf.shape)} vs {spec}"


def test_mesh_oversubscription_rejected_with_recipe():
    """``make_debug_mesh``/``make_production_mesh`` reject a mesh with more
    ranks than there are up front, naming the port's recipe (one process
    a device under ``torchrun``, or the dry run's placeholder group),
    before any process group is started; an in-budget mesh (one rank,
    here) is a real ``DeviceMesh`` (in a subprocess: the group it sets up
    is process-wide)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod

    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        mesh_mod.make_debug_mesh(data=2, model=1, device="cpu")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        mesh_mod.make_debug_mesh(data=2, model=2, device="cpu")
    with pytest.raises(ValueError, match="placeholder_group"):
        mesh_mod.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="xla_force|torchrun") as e:
        mesh_mod.make_production_mesh(multi_pod=True, device="cpu")
    assert "xla_force_host_platform_device_count" not in str(e.value)
    assert not dist.is_initialized()
    code = ("from repro_torch.launch import mesh as m\n"
            "x = m.make_debug_mesh(device='cpu')\n"
            "assert x.shape == (1, 1) and x.mesh_dim_names == "
            "('data', 'model'), x\n"
            "assert m.mesh_chips(x) == 1\n"
            "print('MESH_OK')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert "MESH_OK" in r.stdout, r.stdout + r.stderr


# -- the port's specs against the reference's --------------------------------

def _split(cfg, tree, leaf):
    """The reference's tree in the port's layout: each part the reference
    stacks becomes one tree a layer, each leaf ``leaf(x, layers)``."""
    out = {}
    for key, val in tree.items():
        kind, *rest = convert._layout(cfg)[key]
        if kind == convert.STACK:
            n = rest[0]
            out[key] = [jax.tree.map(lambda x: leaf(x, n), val,
                                     is_leaf=lambda x: isinstance(x, P))
                        for _ in range(n)]
        else:
            out[key] = val
    return out


def _unstack_spec(p, layers):
    assert p[0] is None, p           # the "layers" axis is never sharded
    return P(*tuple(p)[1:])


def _as_tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


@functools.lru_cache(maxsize=None)
def _reference_shapes(arch):
    cfg = C.get(arch)
    params = jax.eval_shape(lambda: rapi.init_params(jax.random.PRNGKey(0),
                                                     cfg))
    opt = jax.eval_shape(lambda: ropt.init(params, ropt.OptConfig(
        state_dtype=cfg.param_dtype)))
    cache = jax.eval_shape(lambda: rapi.init_cache(cfg, 128, max_len=32768,
                                                   enc_len=4096))
    return params, opt, cache


def _reference_bytes(shape, dtype, spec, mesh):
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
    for ax in spec:
        for a in () if ax is None else (ax if isinstance(ax, tuple)
                                        else (ax,)):
            n //= sizes[a]
    return n


CASES = [(a, m, f, c) for a in tconfigs.ARCHS for m in ("16x16", "2x16x16")
         for f in (True, False) for c in ("seq", "heads")]


def _case(arch, mesh_id, fsdp, cache_axis):
    mesh = SINGLE if mesh_id == "16x16" else MULTI
    kw = dict(fsdp=fsdp, cache_axis=cache_axis)
    rrules = rpart.make_rules(C.get(arch), mesh, **kw)
    trules = partition.make_rules(tconfigs.get(arch), mesh, **kw)
    return mesh, rrules, trules


@pytest.mark.parametrize("arch,mesh_id,fsdp,cache_axis", CASES)
def test_resolved_specs_equal_reference(arch, mesh_id, fsdp, cache_axis):
    mesh, rrules, trules = _case(arch, mesh_id, fsdp, cache_axis)
    rcfg, tcfg = C.get(arch), tconfigs.get(arch)
    assert rrules.mapping == trules.mapping
    rparams = rpart.tree_pspecs(rapi.param_specs(rcfg), rrules)
    want = _as_tuples(_split(tcfg, rparams, _unstack_spec))
    got = partition.tree_pspecs(tapi.param_specs(tcfg), trules)
    assert got == want
    # the optimizer state: m and v by the port's leaf names, count ()
    ropt_specs = rpart.tree_pspecs(ropt.state_specs(rapi.param_specs(rcfg)),
                                   rrules)
    got_opt = partition.tree_pspecs(
        topt.state_specs(tapi.param_specs(tcfg)), trules)
    named = dict(topt._named(want))
    assert got_opt == {"m": named, "v": named, "count": ()}
    assert tuple(ropt_specs["count"]) == ()
    assert _as_tuples(_split(tcfg, ropt_specs["m"], _unstack_spec)) == want
    # the caches share the reference's layout
    rcache = rpart.tree_pspecs(rapi.cache_specs(rcfg), rrules)
    gcache = partition.tree_pspecs(tapi.cache_specs(tcfg), trules)
    assert partition.leaves(gcache, partition.is_pspec) == [
        tuple(p) for p in jax.tree.leaves(
            rcache, is_leaf=lambda x: isinstance(x, P))]
    assert type(gcache).__name__ == type(rcache).__name__


@pytest.mark.parametrize("arch,mesh_id,fsdp,cache_axis", CASES)
def test_per_device_bytes_equal_reference(arch, mesh_id, fsdp, cache_axis):
    mesh, rrules, trules = _case(arch, mesh_id, fsdp, cache_axis)
    rcfg, tcfg = C.get(arch), tconfigs.get(arch)
    rshapes, ropt_shapes, rcache = _reference_shapes(arch)
    is_p = lambda x: isinstance(x, P)

    def ref_bytes(shapes, specs):
        return jax.tree.map(lambda p, s: _reference_bytes(
            s.shape, s.dtype, p, mesh), specs, shapes, is_leaf=is_p)

    def per_layer(n, layers):
        assert n % layers == 0
        return n // layers

    def port_bytes(tree, specs):
        return [partition.local_bytes(t, s, mesh) for t, s in zip(
            partition.leaves(tree),
            partition.leaves(specs, partition.is_pspec))]

    # parameters: a stacked leaf's bytes are its layers' together
    rspecs = rpart.tree_pspecs(rapi.param_specs(rcfg), rrules)
    want = partition.leaves(_split(tcfg, ref_bytes(rshapes, rspecs),
                                   per_layer))
    tparams = convert.empty_params(tcfg)
    tspecs = partition.tree_pspecs(tapi.param_specs(tcfg), trules)
    assert port_bytes(tparams, tspecs) == want
    # optimizer state: m and v each the parameters' bytes at state_dtype
    ropt_specs = rpart.tree_pspecs(ropt.state_specs(rapi.param_specs(rcfg)),
                                   rrules)
    rb = ref_bytes(ropt_shapes, ropt_specs)
    assert rb["count"] == 4
    state = topt.init(dict(topt._named(tparams)),
                      topt.OptConfig(state_dtype=tcfg.param_dtype))
    sspecs = partition.tree_pspecs(topt.state_specs(tapi.param_specs(tcfg)),
                                   trules)
    got = port_bytes(state, sspecs)
    m_want = partition.leaves(_split(tcfg, rb["m"], per_layer))
    assert sum(got) == 2 * sum(m_want) + 4
    named_want = dict(topt._named(_split(tcfg, rb["m"], per_layer)))
    assert [partition.local_bytes(state["m"][k], sspecs["m"][k], mesh)
            for k in sorted(named_want)] == [named_want[k]
                                             for k in sorted(named_want)]
    # the cache: the reference's layout, leaf for leaf
    rcs = rpart.tree_pspecs(rapi.cache_specs(rcfg), rrules)
    cache = tapi.init_cache(tcfg, 128, max_len=32768, device="meta",
                            enc_len=4096)
    cspecs = partition.tree_pspecs(tapi.cache_specs(tcfg), trules)
    assert port_bytes(cache, cspecs) == jax.tree.leaves(ref_bytes(rcache,
                                                                  rcs))
