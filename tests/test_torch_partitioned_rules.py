"""The partitioned step's own rules for two layers, on the CPU: decode
attention over a KV cache sharded on its positions, merged by the row
log-sum-exp of ``flash_attention_partial``, and the expert-choice MoE
divided over every rank (``repro_torch.models.moe._moe_partitioned``).

* **The plain log-sum-exp.**  ``ref.mha_ref_lse`` against ``mha_ref``
  (non-causal) and against the JAX package's ``flash_attention`` run as
  ``tests/test_kernels.py`` runs it (interpret mode), its ``lse`` against
  a float64 log-sum-exp of the live scores; a row with no live key gives
  ``o = 0`` and ``lse = -inf``.
* **The merge.**  Attention over 1 to 8 key ranges (Hypothesis draws the
  ranges and the lengths, ranges with no live key included), merged by
  ``ops.merge_partials`` and cast once, against the whole-cache
  ``flash_attention`` within ``ops.TOLERANCE``, float32 and bfloat16.
* **Four real ranks.**  Four ``gloo`` ranks (spawned, ``FileStore``):
  decode attention on ``DTensor`` K and V sharded on their positions, on
  (1, 4) and (2, 2) ``("data", "model")`` meshes, equals the
  unpartitioned call within ``ops.TOLERANCE`` and gathers nothing (rank
  0 counts no all-gather, and three all-reduces a key-sharded mesh dim),
  and so does it over 42 keys on (1, 4), whose shards are uneven (11,
  11, 11 and 9 keys: each rank's first key is its shard's own offset);
  the granite and qwen3-moe smoke train steps on (2, 2) and (4, 1) equal
  the unpartitioned step within ``tests/test_torch_dryrun_partitioned.
  py``'s bounds (qwen3's 8 experts divide the model axis, granite's 5
  do not, so its FFN width is divided instead), and no collective of the
  MoE layer's forward and backward holds E x C x d elements.

The ranks run in one subprocess (a process group is process-wide).
"""
import json
import math
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import repro.configs as C  # noqa: E402
from repro.kernels.flash_attention import kernel as fak  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro_torch.kernels.flash_attention import ops as aops, ref as aref  # noqa: E402

import test_torch_dryrun_partitioned as parted  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
MOE_ARCHS = ("granite_moe_3b_a800m", "qwen3_moe_30b_a3b")
MOE_MESHES = ((2, 2), (4, 1))
#: (mesh, keys): 42 keys on (1, 4) make uneven shards, 11, 11, 11 and 9
#: keys, the last rank's first key 33 (its index times its own shard's
#: size would say 27)
ATTN_CASES = (((1, 4), 64), ((2, 2), 64), ((1, 4), 42))
DTYPES = (torch.float32, torch.bfloat16)
#: the log-sum-exp against a float64 one of the same scores, relative
LSE_RTOL = 1e-5


def _attention(dtype, b=3, h=8, kv=2, sq=1, sk=40, d=16, seed=0,
               lengths=None):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                ).to(dtype)
               for s in ((b, h, sq, d), (b, kv, sk, d), (b, kv, sk, d)))
    if lengths is None:
        lengths = [0, sk] + list(rng.integers(1, sk, b - 2))
    return q, k, v, torch.tensor(lengths, dtype=torch.int32)


def _lse64(q, k, lens):
    """The live scaled scores' log-sum-exp in float64: (B, H, Sq)."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    qf = q.double().reshape(b, kv, h // kv, sq, d)
    s = qf @ k.double()[:, :, None].transpose(-1, -2) / math.sqrt(d)
    live = torch.arange(sk)[None, :] < lens[:, None].long()
    s = torch.where(live[:, None, None, None], s, -math.inf)
    return torch.logsumexp(s, -1).reshape(b, h, sq)


def _lse_close(got, exp):
    dead = torch.isinf(exp)
    assert torch.equal(torch.isinf(got), dead)
    assert bool((got[dead] < 0).all())
    err = (got.double() - exp.double()).abs()[~dead]
    assert bool((err <= LSE_RTOL * exp.double().abs()[~dead].clamp_min(1.0)
                 ).all()), float(err.max())


@pytest.mark.parametrize("kv", [1, 2, 8])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mha_ref_lse_matches_mha_ref(dtype, kv):
    q, k, v, lens = _attention(dtype, kv=kv, sq=2)
    o, lse = aref.mha_ref_lse(q, k, v, lens)
    assert o.dtype == lse.dtype == torch.float32
    assert o.shape == q.shape and lse.shape == q.shape[:-1]
    atol, rtol = aops.TOLERANCE[torch.float32]
    torch.testing.assert_close(o, aref.mha_ref(q, k, v, lens, False),
                               atol=atol, rtol=rtol)
    _lse_close(lse, _lse64(q, k, lens))
    # the row of no live key: zeros and -inf
    assert torch.count_nonzero(o[0]) == 0
    assert bool(torch.isneginf(lse[0]).all())


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_mha_ref_lse_matches_the_reference_kernel(dtype):
    """Against the JAX package's Pallas kernel in interpret mode (KV == H:
    the reference kernel has no grouped heads), at a decode-like tile."""
    rng = np.random.default_rng(1)
    b, h, sq, sk, d = 3, 2, 8, 64, 16
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d))]
    lens = np.array([0, 64, 37], np.int32)
    jq, jk, jv = (jnp.asarray(a, dtype) for a in arrs)
    want = np.asarray(fak.flash_attention(jq, jk, jv, jnp.asarray(lens),
                                          False, tile_q=sq, tile_k=16,
                                          interpret=True), np.float32)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrs)
    o, lse = aref.mha_ref_lse(q, k, v, torch.from_numpy(lens))
    got = o.to(tdt).float().numpy()
    atol, rtol = aops.TOLERANCE[tdt]
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    _lse_close(lse, _lse64(q, k, torch.from_numpy(lens)))


def _merged(q, k, v, lens, bounds):
    """Attention over key ranges ``bounds`` merged, cast to q's type."""
    parts = [aops.flash_attention_partial(
        q, k[:, :, a:e], v[:, :, a:e], (lens - a).clamp(0, e - a))
        for a, e in zip(bounds[:-1], bounds[1:])]
    return aops.merge_partials(torch.stack([p[0] for p in parts]),
                               torch.stack([p[1] for p in parts])
                               ).to(q.dtype)


@given(cuts=st.lists(st.integers(1, 63), min_size=0, max_size=7, unique=True),
       lens=st.lists(st.integers(0, 64), min_size=3, max_size=3),
       dtype=st.sampled_from(DTYPES), seed=st.integers(0, 2 ** 16))
@settings(max_examples=40, deadline=None)
def test_merge_of_key_shards_equals_whole_cache(cuts, lens, dtype, seed):
    """1 to 8 key ranges (their ends drawn), lengths drawn from 0 to all
    64 keys, so ranges with no live key occur."""
    q, k, v, lengths = _attention(dtype, sk=64, seed=seed, lengths=lens)
    bounds = [0] + sorted(cuts) + [64]
    got = _merged(q, k, v, lengths, bounds)
    want = aops.flash_attention(q, k, v, lengths, causal=False)
    atol, rtol = aops.TOLERANCE[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_merge_of_one_shard_is_the_identity(dtype):
    q, k, v, lens = _attention(dtype)
    o, lse = aops.flash_attention_partial(q, k, v, lens)
    assert torch.equal(aops.merge_partials(o[None], lse[None]), o)


def test_partial_takes_decode_rows_only():
    q, k, v, lens = _attention(torch.float32, h=8, kv=2, sq=5)
    with pytest.raises(ValueError, match="query rows"):
        aops.flash_attention_partial(q, k, v, lens)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_partial_fake_and_flops(device):
    from torch.utils.flop_counter import FlopCounterMode
    q, k, v, lens = (t.to(device) for t in _attention(torch.bfloat16))
    o, lse = aops.flash_attention_partial(q, k, v, lens)
    assert (o.shape, o.dtype, o.device.type) == (q.shape, torch.float32,
                                                  device)
    assert (lse.shape, lse.dtype) == (q.shape[:-1], torch.float32)
    counts = []
    for fn in (aops.flash_attention_partial, aref.mha_ref_lse):
        with FlopCounterMode(display=False) as fc:
            fn(q, k, v, lens)
        counts.append(fc.get_total_flops())
    assert counts[0] == counts[1] > 0


RANKS = parted.CELLS + """
import copy
import json
import pickle
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.kernels.flash_attention import ops as aops
from repro_torch.launch import dryrun
from repro_torch.models import convert, moe
from repro_torch.models.common import gather_fsdp
from repro_torch.sharding import partition
from repro_torch.training import optimizer as opt_mod

WEIGHTS, STORE, OUT = {weights!r}, {store!r}, {out!r}
MOE_ARCHS, MOE_MESHES, ATTN_CASES = {archs!r}, {moe_meshes!r}, {attn_cases!r}
TOL, DENSE_TOL, GRAD_TOL = {tol!r}, {dense_tol!r}, {grad_tol!r}

def mesh_of(shape):
    return DeviceMesh("cpu", torch.arange(4).reshape(shape),
                      mesh_dim_names=("data", "model"))

def attention(shape, dtype, sk=64):
    # decode attention over K and V sharded on their positions on "model"
    mesh = mesh_of(shape)
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                ).to(dtype)
               for s in ((4, 8, 1, 16), (4, 2, sk, 16), (4, 2, sk, 16)))
    lens = torch.tensor([0, sk, 13, 40], dtype=torch.int32)
    want = aops.flash_attention(q, k, v, lens, causal=False)
    R, S0 = Replicate(), Shard(0)
    dq = distribute_tensor(q, mesh, [S0, R])
    dk = distribute_tensor(k, mesh, [S0, Shard(2)])
    dv = distribute_tensor(v, mesh, [S0, Shard(2)])
    dl = distribute_tensor(lens, mesh, [S0, R])
    trace = dryrun.StepTrace()
    with trace.mode():
        o = aops.flash_attention(dq, dk, dv, dl, causal=False)
    got = o.full_tensor()
    atol, rtol = aops.TOLERANCE[dtype]
    err = (got.float() - want.float()).abs()
    ok = bool((err <= atol + rtol * want.float().abs()).all())
    return {{"ok": ok, "max_err": float(err.max()),
             "dtype": str(got.dtype), "placements": [str(p) for p in o.placements],
             "collectives": trace.collectives()}}

def real_args(c, tree):
    rng = np.random.default_rng(0)
    model = convert.from_reference(c.cfg, tree)
    state = opt_mod.init(dict(model.named_parameters()), opt_mod.OptConfig())
    tokens = torch.from_numpy(rng.integers(0, c.cfg.vocab, tuple(
        c.args[2]["tokens"].shape)).astype(np.int32))
    return (model, state, {{"tokens": tokens}}, None)

def whole(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t

def compare(arch, got, plain):
    want = partition.leaves(specs.trees(plain))
    grads = {{id(m) for m in partition.leaves(specs.trees(plain[1]["m"]))}}
    bad, worst = [], 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            continue
        g, w = g.double(), w.double()
        atol, rtol = TOL.get(arch, DENSE_TOL)
        if id(w) in grads:
            atol = GRAD_TOL.get(arch, DENSE_TOL[0]) * float(w.abs().max())
            rtol = 0.0
        err = float((g - w).abs().max()) if w.numel() else 0.0
        worst = max(worst, err)
        if not torch.allclose(g, w, atol=atol, rtol=rtol):
            bad.append((i, err))
    return {{"leaves": len(want), "max_err": worst, "bad": bad[:5]}}

def moe_layer(c, shape):
    # the MoE layer alone, forward and backward, on a DTensor batch: every
    # collective it makes
    mesh = mesh_of(shape)
    cfg = c.cfg
    params = c.args[0].params()["blocks"][0]["moe"]
    shards = c.in_shardings[0]["blocks"][0]["moe"]
    rng = np.random.default_rng(2)
    p = {{k: distribute_tensor(torch.from_numpy(rng.standard_normal(tuple(
        t.shape)).astype(np.float32)) * 0.2, mesh,
        shards[k].placements).requires_grad_() for k, t in params.items()}}
    b, s = c.args[2]["tokens"].shape
    x = distribute_tensor(torch.from_numpy(rng.standard_normal(
        (b, s - 1, cfg.d_model)).astype(np.float32)), mesh,
        [Shard(0), Replicate()]).requires_grad_()
    w = gather_fsdp(p)          # the layer's weights as the block uses them
    trace = dryrun.StepTrace()
    with trace.mode():
        out = moe.moe_apply(cfg, w, x)
        out.sum().backward()
    n = b * (s - 1)
    cap = max(1, int(round(n * cfg.top_k / cfg.num_experts)))
    return {{"largest": trace.largest,
             "ecd": cfg.num_experts * cap * cfg.d_model * 4,
             "collectives": trace.collectives()}}

def rank_main(rank):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(STORE, 4),
                            rank=rank, world_size=4)
    partition.register_rules()
    with open(WEIGHTS, "rb") as f:
        weights = pickle.load(f)
    result = {{}}
    for shape, keys in ATTN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            r = attention(shape, dtype, keys)
            if rank == 0:
                result[f"attention/{{shape}}/{{keys}}/{{dtype}}"] = r
    for arch in MOE_ARCHS:
        for shape in MOE_MESHES:
            c = cell(arch, "train", mesh_of(shape), f32(arch))
            args = real_args(c, weights[arch])
            dargs = specs.distribute(c, args=args, local=specs.slice_local)
            out = specs.run_step(c, dargs)
            got = [whole(t) for t in partition.leaves(specs.trees(out))]
            layer = moe_layer(c, shape)
            if rank == 0:
                plain = c.step_fn(*copy.deepcopy(args))
                result[f"moe/{{arch}}/{{shape}}"] = dict(
                    compare(arch, got, plain), layer=layer)
    if rank == 0:
        with open(OUT, "w") as f:
            json.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()

if __name__ == "__main__":
    mp.start_processes(rank_main, nprocs=4, start_method="spawn")
    print("RANKS_OK")
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("partitioned_rules")
    weights = {}
    for arch in MOE_ARCHS:
        rcfg = C.get_smoke(arch).replace(dtype=jnp.float32,
                                         param_dtype=jnp.float32)
        weights[arch] = jax.tree.map(np.asarray, jax.device_get(
            rapi.init_params(jax.random.PRNGKey(0), rcfg)))
    with open(tmp / "weights.pkl", "wb") as f:
        pickle.dump(weights, f)
    (tmp / "ranks.py").write_text(textwrap.dedent(RANKS.format(
        weights=str(tmp / "weights.pkl"), store=str(tmp / "store"),
        out=str(tmp / "ranks.json"), archs=MOE_ARCHS, moe_meshes=MOE_MESHES,
        attn_cases=ATTN_CASES, tol=parted.TOL, dense_tol=parted.DENSE_TOL,
        grad_tol=parted.GRAD_TOL)))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, str(tmp / "ranks.py")],
                         capture_output=True, text=True, timeout=400,
                         cwd=ROOT, env=env)
    assert "RANKS_OK" in run.stdout, run.stdout + run.stderr[-4000:]
    return json.loads((tmp / "ranks.json").read_text())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,keys", ATTN_CASES)
def test_key_sharded_decode_attention_equals_whole(ranks, shape, keys,
                                                   dtype):
    got = ranks[f"attention/{tuple(shape)}/{keys}/{dtype}"]
    assert got["ok"], got
    assert got["dtype"] == str(dtype)
    assert got["placements"] == ["S(0)", "R"]


@pytest.mark.parametrize("shape,keys", ATTN_CASES)
def test_key_sharded_decode_attention_gathers_nothing(ranks, shape, keys):
    for dtype in DTYPES:
        coll = ranks[f"attention/{tuple(shape)}/{keys}/{dtype}"][
            "collectives"]
        assert coll["bytes"]["all-gather"] == 0, coll
        # the merge: the row maxima, the weighted sums and the weights
        assert coll["count"]["all-reduce"] == 3, coll
        assert coll["total_bytes"] == coll["bytes"]["all-reduce"] > 0


@pytest.mark.parametrize("shape", MOE_MESHES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_partitioned_moe_train_step_equals_unpartitioned(ranks, arch, shape):
    got = ranks[f"moe/{arch}/{tuple(shape)}"]
    assert got["leaves"] > 0
    assert got["bad"] == [], got


@pytest.mark.parametrize("shape", MOE_MESHES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_partitioned_moe_holds_no_replica_of_the_expert_rows(ranks, arch,
                                                             shape):
    layer = ranks[f"moe/{arch}/{tuple(shape)}"]["layer"]
    assert 0 < layer["largest"] < layer["ecd"], layer
    assert "unmapped" not in layer["collectives"]
