"""The dry run's step as a partitioned ``DTensor`` program
(``repro_torch.launch.specs.distribute``/``run_step``, counted by
``launch.dryrun.StepTrace``), on the CPU.

* **Four real ranks.**  Four ``gloo`` ranks (spawned, ``FileStore``) on
  a (2, 2) ``("data", "model")`` mesh run each family's smoke config in
  float32, a train step and a decode step, on the reference's weights
  (drawn by JAX, through ``convert``).  Every output leaf of the
  partitioned step, gathered whole, equals the unpartitioned port step's
  on the same inputs within ``atol 1e-5 + rtol 1e-5`` (the gradients in
  AdamW's first moment within 1e-5 of each leaf's largest, loosened for
  zamba2 and xlstm as ``tests/test_torch_families_grad.py`` loosens
  them); rank 0's collectives, kind by kind and byte for byte, and its
  FLOPs equal those of the same cell traced on ``meta`` shards over a
  ``fake`` group of 4 ranks, and so does its peak of live bytes, but for
  one collective's buffer (``gloo``'s worker thread may drop a finished
  collective's buffer after the step has, at a moment of its scheduler's
  choosing: measured, 0 to 65,536 bytes of peaks of 0.14 to 3.0 MB).
* **One rank's FLOPs.**  On every smoke cell (each config, train,
  prefill and decode) one rank's FLOPs times the 4 ranks are no fewer
  than the whole step's (``FlopCounterMode`` of the unpartitioned step).
* **The kernels' operators.**  The fake implementations give the plain
  versions' output shapes and types; the FLOP formulas equal
  ``FlopCounterMode`` of the plain versions; batch- or head-sharded
  operands run with no collective, and a sequence-sharded KV is gathered
  for a query of more than ``DECODE_ROWS`` rows, a causal one or one that
  wants a gradient; decode's query over it
  gathers nothing (each rank attends over its own keys, the ranks merge
  by all-reduces); an expert product whose rows are sharded runs with no
  collective.

The ranks and the ``fake`` group each run in a subprocess of their own
(a process group is process-wide), all started at once.
"""
import json
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import repro.configs as C  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels.flash_attention import ops as aops, ref as aref  # noqa: E402
from repro_torch.kernels.wavefront_matmul import ops as mops, ref as mref  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: one config a family
FAMILY_ARCHS = ("yi_9b", "granite_moe_3b_a800m", "zamba2_1p2b",
                "xlstm_350m", "seamless_m4t_large_v2", "internvl2_2b")
RANK_KINDS = ("train", "decode")
KINDS = ("train", "prefill", "decode")
#: (atol, rtol) of every output leaf against the unpartitioned step, and
#: where ROADMAP.md's queue 3 item 9 loosens the float32 bounds of the
#: SSD and the xLSTM, tests/test_torch_families.py's (``F32_LOOSE``)
TOL = {"zamba2_1p2b": (2e-5, 1e-5), "xlstm_350m": (1e-4, 1e-4)}
DENSE_TOL = (1e-5, 1e-5)
#: the gradients' bound, a share of each leaf's largest gradient: the
#: dense 1e-5, and the loosened bounds of tests/test_torch_families_grad.py
GRAD_TOL = {"zamba2_1p2b": 5e-5, "xlstm_350m": 1e-4}

#: the cells, as both subprocesses build them: 4 sequences of 32 tokens
#: (internvl2's patches before them), a decode cache of 64, 16 frames
CELLS = """
import numpy as np
import torch
from repro_torch import configs
from repro_torch.launch import specs

def shape(cfg, kind):
    if kind == "decode":
        return configs.ShapeSpec("decode_small", 64, 4, kind)
    s = 32 + (cfg.num_patches if cfg.family == "vlm" else 0)
    return configs.ShapeSpec(kind + "_small", s, 4, kind)

def f32(arch):
    return configs.get_smoke(arch).replace(dtype=torch.float32,
                                           param_dtype=torch.float32)

def cell(arch, kind, mesh, cfg=None):
    cfg = cfg or configs.get_smoke(arch)
    return specs.build_cell(arch, None, mesh, cfg=cfg, shape=shape(cfg, kind),
                            enc_len=16)
"""

RANKS = CELLS + """
import copy
import json
import pickle
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.launch import dryrun
from repro_torch.models import api, convert
from repro_torch.models.attention import KVCache
from repro_torch.training import optimizer as opt_mod

WEIGHTS, STORE, OUT = {weights!r}, {store!r}, {out!r}
ARCHS, KINDS = {archs!r}, {kinds!r}
TOL, DENSE_TOL, GRAD_TOL = {tol!r}, {dense_tol!r}, {grad_tol!r}

def real_args(c, tree):
    cfg = c.cfg
    rng = np.random.default_rng(0)
    model = convert.from_reference(cfg, tree)
    if c.shape.kind == "train":
        state = opt_mod.init(dict(model.named_parameters()),
                             opt_mod.OptConfig())
        batch = {{}}
        for k, t in c.args[2].items():
            if t.dtype.is_floating_point:
                batch[k] = torch.from_numpy(rng.standard_normal(
                    tuple(t.shape)).astype(np.float32) * 0.5)
            else:
                batch[k] = torch.from_numpy(rng.integers(
                    0, cfg.vocab, tuple(t.shape)).astype(np.int32))
        return (model, state, batch, None)
    b = c.shape.global_batch
    cache = api.init_cache(cfg, b, max_len=c.shape.seq_len, device="cpu",
                           enc_len=16)
    # random K/V rows, the recurrent states fresh (zamba2's SSM state,
    # xlstm's cells: from a random state, float32's reordering grows about
    # 2x a layer, 1.2e-4 on states of up to 15.7 after 4 zamba2 layers),
    # 16 live encoder frames
    rand = lambda t: torch.from_numpy(rng.standard_normal(tuple(
        t.shape)).astype(np.float32) * 0.5).to(t.dtype)
    if cfg.family == "mamba_hybrid":
        cache["kv"] = KVCache(*map(rand, cache["kv"]))
    elif cfg.family == "encdec":
        cache = dict(cache, self=KVCache(*map(rand, cache["self"])),
                     cross_k=rand(cache["cross_k"]),
                     cross_v=rand(cache["cross_v"]),
                     enc_len=torch.full((b,), 16, dtype=torch.int32))
    elif cfg.family != "xlstm":
        cache = KVCache(*map(rand, cache))
    token = torch.from_numpy(rng.integers(0, cfg.vocab, b).astype(np.int32))
    lengths = torch.from_numpy(rng.integers(3, 40, b).astype(np.int32))
    active = torch.ones((b,), dtype=torch.int32)
    return (model, cache, token, lengths, active)

def whole(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t

def compare(arch, kind, got, plain):
    # the partitioned step's outputs (whole) against the unpartitioned
    # step's: each leaf within its bound
    want = dryrun.partition.leaves(specs.trees(plain))
    worst, bad = 0.0, []
    grads = set()
    if kind == "train":
        grads = {{id(m) for m in dryrun.partition.leaves(
            specs.trees(plain[1]["m"]))}}
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            continue
        grad = id(w) in grads
        g, w = g.double(), w.double()
        atol, rtol = TOL.get(arch, DENSE_TOL)
        if grad:
            atol = GRAD_TOL.get(arch, DENSE_TOL[0]) * float(
                w.abs().max()) if w.numel() else 0.0
            rtol = 0.0
        err = float((g - w).abs().max()) if w.numel() else 0.0
        worst = max(worst, err)
        if not torch.allclose(g, w, atol=atol, rtol=rtol):
            bad.append((i, err))
    return {{"leaves": len(want), "max_err": worst, "bad": bad[:5]}}

def rank_main(rank):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(STORE, 4),
                            rank=rank, world_size=4)
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    with open(WEIGHTS, "rb") as f:
        weights = pickle.load(f)
    result = {{}}
    for arch in ARCHS:
        for kind in KINDS:
            c = cell(arch, kind, mesh, f32(arch))
            args = real_args(c, weights[arch])
            dargs = specs.distribute(c, args=args, local=specs.slice_local)
            trace = dryrun.StepTrace(known=specs.arg_tensors(dargs))
            with trace.mode():
                out = specs.run_step(c, dargs)
            got = [whole(t) for t in dryrun.partition.leaves(specs.trees(out))]
            if rank == 0:
                # a copy: the model's leaves share the loaded weights'
                # memory, which every rank's next cell reads
                plain = c.step_fn(*copy.deepcopy(args))
                result[f"{{arch}}/{{kind}}"] = dict(
                    compare(arch, kind, got, plain),
                    collectives=trace.collectives(), flops=trace.flops,
                    peak=trace.peak)
    if rank == 0:
        with open(OUT, "w") as f:
            json.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()

if __name__ == "__main__":
    mp.start_processes(rank_main, nprocs=4, start_method="spawn")
    print("RANKS_OK")
"""

FAKE = CELLS + """
import json
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.kernels.flash_attention import ops as aops
from repro_torch.kernels.wavefront_matmul import ops as mops
from repro_torch.launch import dryrun
from repro_torch.sharding import partition

OUT, ARCHS, KINDS = {out!r}, {archs!r}, {kinds!r}
dryrun.placeholder_group(4)
mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                  mesh_dim_names=("data", "model"))
result = {{}}
for arch in ARCHS:
    for kind in KINDS:
        c = cell(arch, kind, mesh, f32(arch))
        with FlopCounterMode(display=False) as fc:
            c.step_fn(*c.args)
        args = specs.distribute(c)
        trace = dryrun.StepTrace(known=specs.arg_tensors(args))
        with trace.mode():
            specs.run_step(c, args)
        result[f"{{arch}}/{{kind}}"] = {{
            "collectives": trace.collectives(), "flops": trace.flops,
            "peak": trace.peak, "whole": fc.get_total_flops(),
            "largest": trace.largest}}

# the kernels' rules: batch- and head-sharded operands, a KV sharded on
# the sequence (a causal query: gathered), decode's query over such a KV
# (no gather) and an expert product sharded on its rows
partition.register_rules()
R, S0, S1, S2 = Replicate(), Shard(0), Shard(1), Shard(2)
def dt(shape, place, dtype=torch.float32):
    local = list(shape)
    for i, p in enumerate(place):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.shape[i]
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return DTensor.from_local(torch.empty(local, dtype=dtype, device="meta"),
                              mesh, place, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))
rules = {{}}
for name, place, kv_place in (("batch", [S0, R], [S0, R]),
                              ("heads", [R, S1], [R, S1]),
                              ("both", [S0, S1], [S0, S1]),
                              ("kv_seq", [S0, S1], [S0, S2])):
    q = dt((4, 4, 8, 16), place).requires_grad_()
    k = dt((4, 2, 8, 16), kv_place).requires_grad_()
    v = dt((4, 2, 8, 16), kv_place).requires_grad_()
    lens = dt((4,), [p if p == S0 else R for p in place], torch.int32)
    trace = dryrun.StepTrace()
    with trace.mode():
        o = aops.flash_attention(q, k, v, lens)
        fwd = trace.collectives()["total_bytes"]
        o.backward(torch.ones_like(o))
    rules["attention/" + name] = {{
        "fwd": fwd, "all": trace.collectives()["total_bytes"],
        "out": [str(p) for p in o.placements]}}
q = dt((4, 4, 1, 16), [S0, R])
k, v = dt((4, 2, 8, 16), [S0, S2]), dt((4, 2, 8, 16), [S0, S2])
lens = dt((4,), [S0, R], torch.int32)
trace = dryrun.StepTrace()
with trace.mode():
    o = aops.flash_attention(q, k, v, lens, causal=False)
rules["attention/decode_kv_seq"] = {{
    "fwd": trace.collectives()["total_bytes"],
    "gathered": trace.collectives()["bytes"]["all-gather"],
    "out": [str(p) for p in o.placements]}}
for name, place, act_place, m in (("experts", [S0, R], [S0, R], 200),
                                  ("experts2", [S0, S0], [S0, S0], 200),
                                  ("rows", [S1, R], [S1, R], 512),
                                  ("rows_one_tile", [S1, S0], [R, S0], 100)):
    a = dt((4, m, 32), place).requires_grad_()
    b = dt((4, 32, 48), [S0 if p == S0 else R for p in place]
           ).requires_grad_()
    act = dt((4, -(-m // 128)), act_place, torch.int32)
    trace = dryrun.StepTrace()
    with trace.mode():
        out = mops.wavefront_matmul(a, b, act)
        fwd = trace.collectives()["total_bytes"]
        out.backward(torch.ones_like(out))
    rules["matmul/" + name] = {{
        "fwd": fwd, "all": trace.collectives()["total_bytes"],
        "out": [str(p) for p in out.placements]}}
result["rules"] = rules
with open(OUT, "w") as f:
    json.dump(result, f)
print("FAKE_OK")
"""


def _reference_weights():
    out = {}
    for arch in FAMILY_ARCHS:
        rcfg = C.get_smoke(arch).replace(dtype=jnp.float32,
                                         param_dtype=jnp.float32)
        out[arch] = jax.tree.map(np.asarray, jax.device_get(
            rapi.init_params(jax.random.PRNGKey(0), rcfg)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both subprocesses' results: ``(ranks, fake)``."""
    tmp = tmp_path_factory.mktemp("partitioned")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    (tmp / "fake.py").write_text(textwrap.dedent(FAKE.format(
        out=str(tmp / "fake.json"), archs=tconfigs.ARCHS, kinds=KINDS)))
    fake = subprocess.Popen([sys.executable, str(tmp / "fake.py")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=ROOT, env=env)
    with open(tmp / "weights.pkl", "wb") as f:
        pickle.dump(_reference_weights(), f)
    (tmp / "ranks.py").write_text(textwrap.dedent(RANKS.format(
        weights=str(tmp / "weights.pkl"), store=str(tmp / "store"),
        out=str(tmp / "ranks.json"), archs=FAMILY_ARCHS, kinds=RANK_KINDS,
        tol=TOL, dense_tol=DENSE_TOL, grad_tol=GRAD_TOL)))
    ranks = subprocess.run([sys.executable, str(tmp / "ranks.py")],
                           capture_output=True, text=True, timeout=400,
                           cwd=ROOT, env=env)
    f_out, f_err = fake.communicate(timeout=400)
    assert "RANKS_OK" in ranks.stdout, ranks.stdout + ranks.stderr[-4000:]
    assert "FAKE_OK" in f_out, f_out + f_err[-4000:]
    return (json.loads((tmp / "ranks.json").read_text()),
            json.loads((tmp / "fake.json").read_text()))


@pytest.mark.parametrize("kind", RANK_KINDS)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_partitioned_step_equals_unpartitioned(runs, arch, kind):
    got = runs[0][f"{arch}/{kind}"]
    assert got["leaves"] > 0
    assert got["bad"] == [], got


@pytest.mark.parametrize("kind", RANK_KINDS)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_real_ranks_count_what_the_meta_trace_counts(runs, arch, kind):
    real, meta = runs[0][f"{arch}/{kind}"], runs[1][f"{arch}/{kind}"]
    assert real["collectives"] == meta["collectives"]
    assert real["collectives"]["total_bytes"] > 0
    assert "unmapped" not in real["collectives"]
    assert real["flops"] == meta["flops"] > 0
    # the peak: equal, but for one collective's buffer that gloo's worker
    # thread, not the step, drops last, at a moment of its scheduler's
    assert meta["peak"] > 0
    assert abs(real["peak"] - meta["peak"]) <= meta["largest"], (real, meta)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_one_rank_flops_times_ranks_cover_the_step(runs, arch, kind):
    got = runs[1][f"{arch}/{kind}"]
    assert 0 < got["flops"] and got["flops"] * 4 >= got["whole"], got


def test_kernel_rules_keep_batch_and_head_shards(runs):
    rules = runs[1]["rules"]
    for name in ("batch", "heads", "both"):
        assert rules[f"attention/{name}"]["fwd"] == 0, (name, rules)
    assert rules["attention/batch"]["out"] == ["S(0)", "R"]
    assert rules["attention/heads"]["out"] == ["R", "S(1)"]
    # a KV sharded on the sequence is gathered for the kernel
    assert rules["attention/kv_seq"]["fwd"] > 0
    for name in ("experts", "experts2"):
        assert rules[f"matmul/{name}"]["fwd"] == 0, (name, rules)
        assert rules[f"matmul/{name}"]["out"][0] == "S(0)"
    # rows sharded: whole 128-row tiles, or all rows in one tile
    for name in ("rows", "rows_one_tile"):
        assert rules[f"matmul/{name}"]["fwd"] == 0, (name, rules)
        assert rules[f"matmul/{name}"]["out"][0] == "S(1)"


def test_decode_over_a_sequence_sharded_kv_gathers_nothing(runs):
    rule = runs[1]["rules"]["attention/decode_kv_seq"]
    assert rule["gathered"] == 0 and rule["fwd"] > 0, rule
    assert rule["out"] == ["S(0)", "R"]


def _attention_inputs(dtype):
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((2, 4, 9, 16), generator=gen).to(dtype)
    k = torch.randn((2, 2, 11, 16), generator=gen).to(dtype)
    v = torch.randn((2, 2, 11, 16), generator=gen).to(dtype)
    return q, k, v, torch.tensor([11, 5], dtype=torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_implementations_match_plain_outputs(dtype):
    q, k, v, lens = _attention_inputs(dtype)
    meta = lambda t: t.to("meta")
    o = aref.mha_ref(q, k, v, lens, True).to(dtype)
    fo = aops.flash_attention(*map(meta, (q, k, v, lens)))
    assert (fo.shape, fo.dtype, fo.device.type) == (o.shape, o.dtype, "meta")
    plain = aref.mha_ref_bwd(q, k, v, o, o, lens, True)
    fake = aops.attention_bwd(*map(meta, (q, k, v, o, o, lens)))
    for p, f in zip(plain, fake):
        assert (f.shape, f.dtype, f.device.type) == (p.shape, p.dtype, "meta")
    a = torch.randn((3, 200, 64)).to(dtype)
    b = torch.randn((3, 64, 48)).to(dtype)
    act = torch.tensor([[1, 0], [1, 1], [0, 1]], dtype=torch.int32)
    c = mref.wavefront_matmul_ref(a, b, act)
    fc = mops.wavefront_matmul(*map(meta, (a, b, act)))
    assert (fc.shape, fc.dtype, fc.device.type) == (c.shape, c.dtype, "meta")
    plain = mref.wavefront_matmul_ref_bwd(a, b, act, c)
    fake = mops.matmul_bwd(*map(meta, (a, b, act, c)))
    for p, f in zip(plain, fake):
        assert (f.shape, f.dtype, f.device.type) == (p.shape, p.dtype, "meta")


def _flops(fn, *args):
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_flop_formulas_equal_plain_versions(device):
    q, k, v, lens = (t.to(device) for t in _attention_inputs(torch.float32))
    plain = lambda *a: aref.mha_ref(*a)
    assert _flops(aops.flash_attention, q, k, v, lens) == \
        _flops(plain, q, k, v, lens) > 0
    assert _flops(aops.attention_bwd, q, k, v, q, q, lens) == \
        _flops(aref.mha_ref_bwd, q, k, v, q, q, lens) > 0
    a = torch.empty((3, 200, 64), device=device)
    b = torch.empty((3, 64, 48), device=device)
    act = torch.ones((3, 2), dtype=torch.int32, device=device)
    c = torch.empty((3, 200, 48), device=device)
    assert _flops(mops.wavefront_matmul, a, b, act) == \
        _flops(mref.wavefront_matmul_ref, a, b, act) > 0
    assert _flops(mops.matmul_bwd, a, b, act, c) == \
        _flops(mref.wavefront_matmul_ref_bwd, a, b, act, c) > 0
