"""The port on the card: the hand-written CUDA kernels against their
plain versions, and the CUDA runs against the port's CPU runs.

Every test here needs an NVIDIA GPU with nvcc; without one each skips
(decided in the fixture, never at import).  Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX (the card's machine has none): the CPU runs of
the port stand in for the reference, which ``test_torch_executor.py``
ties them to.  Tolerance: none, bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_port as tp  # noqa: E402
from repro_torch import programs as tprog  # noqa: E402
from repro_torch.core import Asm, EGPUConfig, Op, executor, run_program  # noqa: E402
from repro_torch.core.machine import state_to_numpy  # noqa: E402
from repro_torch.fleet import fleet_run, serve_jobs, unstack_state  # noqa: E402
from repro_torch.kernels.dot_product import ops as dops, ref as dref  # noqa: E402
from repro_torch.kernels.wavefront_alu import ops as wops, ref as wref  # noqa: E402

pytestmark = pytest.mark.cuda

SPECIAL = np.array([0, 0x80000000, 0x7F800000, 0xFF800000, 0x7FA00000,
                    0xFFB00000, 0x7F800001, 0x00400000, 0x80400000,
                    0x3F800000, 0x00800000], np.uint32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: pytest -m cuda)")
    return torch.device("cuda")


def _special(rng, shape):
    bits = rng.integers(0, 2**32, int(np.prod(shape)),
                        dtype=np.uint64).astype(np.uint32)
    pick = rng.random(bits.size) < 0.5
    bits[pick] = SPECIAL[rng.integers(0, len(SPECIAL), pick.sum())]
    return torch.from_numpy(bits.view(np.float32).reshape(shape))


@pytest.mark.parametrize("op", wref.OPS)
@pytest.mark.parametrize("rows,lanes", [(2, 16), (32, 16), (64, 256)])
def test_wavefront_alu_kernel_equals_plain(dev, op, rows, lanes):
    rng = np.random.default_rng(rows * lanes)
    a, b, init = (_special(rng, (rows, lanes)).to(dev) for _ in range(3))
    act = torch.from_numpy(rng.integers(0, 2, -(-rows // 8))
                           .astype(np.int32)).to(dev)
    before = wops.wavefront_alu.launches
    got = wops.wavefront_alu(a, b, init, act, op)
    exp = wref.wavefront_alu_ref(a, b, init, act, op)
    assert wops.wavefront_alu.launches == before + 1
    assert torch.equal(got.view(torch.int32), exp.view(torch.int32))


@pytest.mark.parametrize("shape", [(8, 128), (3, 32, 16), (32, 512)])
def test_dot_product_kernel_equals_plain(dev, shape):
    rng = np.random.default_rng(len(shape))
    a, b = _special(rng, shape).to(dev), _special(rng, shape).to(dev)
    tiles = shape[:-2] + (-(-shape[-2] // 8),)
    act = torch.from_numpy(rng.integers(0, 2, tiles).astype(np.int32)).to(dev)
    got = dops.dot_product(a, b, act)
    exp = dref.dot_product_ref(a, b, act)
    assert torch.equal(got.view(torch.int32), exp.view(torch.int32))


def test_run_program_and_fleet_equal_cpu(dev):
    cfg = tp.config(EGPUConfig, "dp")
    jobs = tp.suite(tprog, cfg)
    cpu = {}
    for i, b in jobs.items():
        cpu[i] = state_to_numpy(run_program(
            b.image, shared_init=b.shared_init, tdx_dim=b.tdx_dim,
            device="cpu"))
        got = state_to_numpy(run_program(
            b.image, shared_init=b.shared_init, tdx_dim=b.tdx_dim,
            device=dev))
        tp.assert_leaves_equal(cpu[i], got, b.name)
    order = sorted(jobs)
    out = fleet_run([jobs[i].image for i in order],
                    init_kw=[dict(shared_init=jobs[i].shared_init,
                                  tdx_dim=jobs[i].tdx_dim) for i in order],
                    device=dev)
    for k, i in enumerate(order):
        tp.assert_leaves_equal(cpu[i], state_to_numpy(unstack_state(out, k)),
                               f"fleet {jobs[i].name}")


def test_step_loop_never_syncs(dev, monkeypatch):
    """No host-device synchronisation inside the step loop, single core
    or fleet: every op of the suite (LODI, LOD, STO, FP, DOT/SUM, IF/
    ELSE/ENDIF, ...) runs under CUDA's sync debug mode set to error."""
    inner = executor.run_steps

    def guarded(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            inner(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(executor, "run_steps", guarded)
    jobs = tp.suite(tprog, tp.config(EGPUConfig, "dp"))
    for b in jobs.values():
        run_program(b.image, shared_init=b.shared_init, tdx_dim=b.tdx_dim,
                    device=dev)
    fleet_run([b.image for b in jobs.values()],
              init_kw=[dict(shared_init=b.shared_init, tdx_dim=b.tdx_dim)
                       for b in jobs.values()], device=dev)


# --- the eGPU step kernels (the main path's FP and DOT/SUM steps) ------------

def _step_args(rng, batch, with_pred, threads=512, nregs=32):
    """A register file of special values and one trace row a core, the
    cores' opcodes mixing FP, DOT, SUM and others, rd/ra/rb often equal."""
    regs = _special(rng, (batch, threads, nregs)).view(torch.int32)
    pool = [int(o) for o in executor.FP_OPCODES + executor.EXT_OPCODES] \
        + [int(Op.ADD), int(Op.LOD), int(Op.NOP)]
    rows = np.zeros((batch, 7), np.int64)
    rows[:, 0] = rng.choice(pool, batch)
    rows[:, 2:5] = rng.integers(0, 4, (batch, 3))
    rows[:, 6] = rng.integers(0, 16, batch)
    masks = torch.from_numpy(rng.random((batch, 16, threads)) < 0.7)
    pred = torch.from_numpy(rng.random((batch, threads)) < 0.6) \
        if with_pred else None
    return regs, torch.from_numpy(rows), masks, pred


@pytest.mark.parametrize("with_pred", [False, True], ids=["nopred", "pred"])
@pytest.mark.parametrize("batch", [1, 4, 18])
def test_step_kernels_equal_plain(dev, batch, with_pred):
    """Each step kernel, one launch, equals its plain version bit for bit
    at the main path's shapes (512 threads, 32 registers)."""
    rng = np.random.default_rng(batch + 10 * with_pred)
    regs, rows, masks, pred = _step_args(rng, batch, with_pred)
    if batch == 1:
        rows[0, 0] = int(Op.FMUL)
    to = lambda x: None if x is None else x.to(dev)
    for run, ref, counter, opcodes in (
            (wops.fp_step, wref.fp_step_ref, wops.wavefront_alu,
             executor.FP_OPCODES),
            (dops.ext_step, dref.ext_step_ref, dops.dot_product,
             executor.EXT_OPCODES)):
        got, exp = regs.clone().to(dev), regs.clone().to(dev)
        before = dict(counter.by_route)
        run(got, to(rows), to(masks), to(pred), opcodes)
        assert counter.by_route == {"step": before["step"] + 1,
                                    "tile": before["tile"]}
        ref(exp, to(rows), to(masks), to(pred), opcodes)
        assert torch.equal(got, exp), run.__name__
    # a DOT on every core: every core's thread 0 written
    rows[:, 0] = int(Op.DOT)
    got, exp = regs.clone().to(dev), regs.clone().to(dev)
    dops.ext_step(got, to(rows), to(masks), to(pred), executor.EXT_OPCODES)
    dref.ext_step_ref(exp, to(rows), to(masks), to(pred), executor.EXT_OPCODES)
    assert torch.equal(got, exp)


def _mixed_programs(cfg, n=9):
    """Core k runs the same instructions rotated by k, so each step mixes
    FP opcodes, DOT, SUM, integer, LOD, STO and NOP across the cores."""
    slots = (lambda a: a.fadd(4, 2, 3), lambda a: a.fmul(2, 2, 3),
             lambda a: a.fmin(3, 2, 3), lambda a: a.dot(5, 2, 3),
             lambda a: a.sum_(6, 3), lambda a: a.add(7, 1, 1),
             lambda a: a.lod(8, 1, 16), lambda a: a.sto(4, 1, 64),
             lambda a: a.nop())
    out = []
    for k in range(n):
        a = Asm(cfg)
        a.tdx(1)
        a.lod(2, 1, 0)
        a.lod(3, 1, 32)
        for j in range(len(slots)):
            slots[(j + k) % len(slots)](a)
        a.stop()
        out.append(a.assemble(schedule_nops=False))
    return out


def test_fp_and_dot_steps_launch_once_each(dev, monkeypatch):
    """On the main path an FP step and a DOT/SUM step each launch their
    step kernel once, for one core and for a fleet step whose cores mix
    every kind of op; the tile routes are not launched; no step syncs;
    the leaves equal the port's CPU run."""
    cfg = tp.config(EGPUConfig, "dp")
    images = _mixed_programs(cfg)
    rng = np.random.default_rng(5)
    shared = [rng.standard_normal(96).astype(np.float32) for _ in images]
    counters = (wops.wavefront_alu, dops.dot_product)
    inner = executor.run_steps

    def guarded(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            inner(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(executor, "run_steps", guarded)
    before = [dict(c.by_route) for c in counters]
    got = state_to_numpy(run_program(images[0], shared_init=shared[0],
                                     device=dev))
    moved = [{r: c.by_route[r] - b[r] for r in b}
             for c, b in zip(counters, before)]
    assert moved == [{"step": 3, "tile": 0}, {"step": 2, "tile": 0}]
    tp.assert_leaves_equal(state_to_numpy(run_program(
        images[0], shared_init=shared[0], device="cpu")), got, "one core")
    before = [dict(c.by_route) for c in counters]
    kw = [dict(shared_init=x) for x in shared]
    out = fleet_run(images, init_kw=kw, device=dev)
    moved = [{r: c.by_route[r] - b[r] for r in b}
             for c, b in zip(counters, before)]
    # 9 rotated slots: a step holds FP iff one of its 9 cores runs one
    assert moved == [{"step": 9, "tile": 0}, {"step": 9, "tile": 0}]
    cpu = fleet_run(images, init_kw=kw, device="cpu")
    for k in range(len(images)):
        tp.assert_leaves_equal(state_to_numpy(unstack_state(cpu, k)),
                               state_to_numpy(unstack_state(out, k)),
                               f"fleet core {k}")


# --- the LM kernels and the serving path --------------------------------------

def _within(got, exp, tol):
    atol, rtol = tol
    g, e = got.float(), exp.float()
    return bool(((g - e).abs() <= atol + rtol * e.abs()).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,m,k,n", [(1, 128, 128, 128), (1, 384, 256, 128),
                                     (5, 200, 48, 64), (40, 2, 96, 32),
                                     (3, 819, 160, 96),
                                     # the granite serve's expert GEMMs:
                                     # up and down, prefill and decode
                                     (40, 819, 1536, 512),
                                     (40, 819, 512, 1536),
                                     (40, 2, 1536, 512), (40, 2, 512, 1536)])
def test_wavefront_matmul_kernel_equals_plain(dev, dtype, e, m, k, n):
    from repro_torch.kernels.wavefront_matmul import ops as mops, ref as mref
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    a = torch.randn((e, m, k), generator=g, device=dev).to(dtype)
    b = (torch.randn((e, k, n), generator=g, device=dev) / k ** 0.5).to(dtype)
    act = torch.randint(0, 2, (e, -(-m // 128)), generator=g, device=dev,
                        dtype=torch.int32)
    act[0, 0] = 1
    if e == 1:
        a, b, act = a[0], b[0], act[0]
    before = mops.wavefront_matmul.launches
    got = mops.wavefront_matmul(a, b, act)
    assert mops.wavefront_matmul.launches == before + 1
    exp = mref.wavefront_matmul_ref(a, b, act)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert _within(got, exp, mops.TOLERANCE[dtype])
    off = ~mref.tile_mask(act, m)
    assert torch.count_nonzero(got[off]) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,sq,sk,d,causal", [
    (2, 2, 2, 128, 256, 64, True), (2, 2, 2, 128, 128, 64, False),
    (2, 6, 2, 37, 37, 12, True), (3, 24, 8, 1, 1024, 64, False),
    (2, 4, 2, 100, 300, 128, True), (2, 4, 4, 16, 48, 16, False)])
def test_flash_attention_kernel_equals_plain(dev, dtype, b, h, kv, sq, sk,
                                             d, causal):
    from repro_torch.kernels.flash_attention import ops as fops, ref as fref
    g = torch.Generator(device=dev).manual_seed(sq + sk + d)
    q = torch.randn((b, h, sq, d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, kv, sk, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, kv, sk, d), generator=g, device=dev).to(dtype)
    lens = torch.randint(1, sk + 1, (b,), generator=g, device=dev,
                         dtype=torch.int32)
    lens[0] = sk
    before = fops.flash_attention.launches
    got = fops.flash_attention(q, k, v, lens, causal)
    assert fops.flash_attention.launches == before + 1
    exp = fref.mha_ref(q, k, v, lens, causal).to(dtype)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert _within(got, exp, fops.TOLERANCE[dtype])
    # poisoned keys past each request's length change nothing
    k2, v2 = k.clone(), v.clone()
    for i, n in enumerate(lens.tolist()):
        k2[i, :, n:] = 1e4
        v2[i, :, n:] = -1e4
    assert torch.equal(fops.flash_attention(q, k2, v2, lens, causal), got)


@pytest.mark.parametrize("route,dtype,e,m,k,n", [
    # wgmma: the 51-row last tile of M = 819, ragged K (48, 160), N = 96
    ("wgmma", torch.bfloat16, 40, 819, 1536, 512),
    ("wgmma", torch.bfloat16, 3, 819, 160, 96),
    ("wgmma", torch.bfloat16, 5, 200, 48, 64),
    ("wgmma", torch.bfloat16, 2, 17, 64, 8),
    # small_m: 1, 2 and 16 rows, both types
    ("small_m", torch.bfloat16, 40, 2, 1536, 512),
    ("small_m", torch.bfloat16, 40, 1, 512, 1536),
    ("small_m", torch.bfloat16, 6, 16, 160, 96),
    ("small_m", torch.float32, 40, 2, 512, 1536),
    ("small_m", torch.float32, 6, 16, 48, 36),
    ("small_m", torch.float32, 5, 1, 100, 24),
    # simt: float32 above 16 rows, rows TMA cannot read
    ("simt", torch.float32, 3, 819, 160, 96),
    ("simt", torch.bfloat16, 5, 200, 100, 64),
    ("simt", torch.bfloat16, 3, 2, 64, 36)])
def test_wavefront_matmul_each_route(dev, route, dtype, e, m, k, n):
    """Each route on the shapes it is chosen for: within tolerance of the
    plain version, inactive tiles exactly zero, its counter moved."""
    from repro_torch.kernels.wavefront_matmul import ops as mops, ref as mref
    g = torch.Generator(device=dev).manual_seed(e * m + k + n)
    a = torch.randn((e, m, k), generator=g, device=dev).to(dtype)
    b = (torch.randn((e, k, n), generator=g, device=dev) / k ** 0.5).to(dtype)
    act = torch.randint(0, 2, (e, -(-m // 128)), generator=g, device=dev,
                        dtype=torch.int32)
    act[0, 0] = 1
    act[-1, -1] = 0
    assert mops.route(a, b) == route
    before = dict(mops.wavefront_matmul.by_route)
    got = mops.wavefront_matmul(a, b, act)
    after = mops.wavefront_matmul.by_route
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == route) for r in after}
    exp = mref.wavefront_matmul_ref(a, b, act)
    torch.cuda.synchronize()
    assert _within(got, exp, mops.TOLERANCE[dtype])
    assert torch.count_nonzero(got[~mref.tile_mask(act, m)]) == 0
    zero = mops.wavefront_matmul(a, b, torch.zeros_like(act))
    assert torch.count_nonzero(zero) == 0


@pytest.mark.parametrize("e,m,k,n", [(40, 819, 1536, 512), (40, 2, 512, 1536),
                                     (6, 16, 160, 96)])
def test_wavefront_matmul_previous_design_on_bf16(dev, e, m, k, n):
    """The simt kernel, the first design, still takes bf16 when named, and
    agrees with the routed kernel within twice the tolerance."""
    from repro_torch.kernels.wavefront_matmul import ops as mops, ref as mref
    g = torch.Generator(device=dev).manual_seed(m + k)
    a = torch.randn((e, m, k), generator=g, device=dev).bfloat16()
    b = (torch.randn((e, k, n), generator=g, device=dev) / k ** 0.5).bfloat16()
    act = torch.ones((e, -(-m // 128)), device=dev, dtype=torch.int32)
    before = mops.wavefront_matmul.by_route["simt"]
    old = mops.run_route("simt", a, b, act)
    assert mops.wavefront_matmul.by_route["simt"] == before + 1
    exp = mref.wavefront_matmul_ref(a, b, act)
    torch.cuda.synchronize()
    assert _within(old, exp, mops.TOLERANCE[torch.bfloat16])
    with pytest.raises(ValueError, match="wgmma"):
        mops.run_route("wgmma", a.float(), b.float(), act)


@pytest.mark.parametrize("b,h,kv,sq,sk,d,causal", [
    (8, 24, 8, 512, 512, 64, True),       # the granite serve's prefill
    (3, 6, 2, 200, 200, 64, True),        # G = 3, ragged lengths
    (2, 6, 2, 100, 300, 128, True),       # head_dim 128, Sk > Sq
    (2, 4, 1, 130, 130, 128, False),      # G = 4: two head groups
    (2, 2, 2, 96, 200, 32, True)])        # head_dim below 64
def test_flash_attention_wgmma_route(dev, b, h, kv, sq, sk, d, causal):
    from repro_torch.kernels.flash_attention import ops as fops, ref as fref
    g = torch.Generator(device=dev).manual_seed(b * h + sq + d)
    mk = lambda *s: torch.randn(s, generator=g, device=dev).bfloat16()
    q, k, v = mk(b, h, sq, d), mk(b, kv, sk, d), mk(b, kv, sk, d)
    lens = torch.randint(1, sk + 1, (b,), generator=g, device=dev,
                         dtype=torch.int32)
    lens[0] = sk
    assert fops.route(q, k, v) == "wgmma"
    before = dict(fops.flash_attention.by_route)
    got = fops.flash_attention(q, k, v, lens, causal)
    assert fops.flash_attention.by_route["wgmma"] == before["wgmma"] + 1
    assert fops.flash_attention.by_route["simt"] == before["simt"]
    exp = fref.mha_ref(q, k, v, lens, causal).bfloat16()
    torch.cuda.synchronize()
    assert _within(got, exp, fops.TOLERANCE[torch.bfloat16])
    # poisoned keys past each request's length change no bit
    k2, v2 = k.clone(), v.clone()
    for i, n in enumerate(lens.tolist()):
        k2[i, :, n:] = 1e4
        v2[i, :, n:] = -1e4
    assert torch.equal(fops.flash_attention(q, k2, v2, lens, causal), got)
    # the previous design on the same inputs
    old = fops.run_route("simt", q, k, v, lens, causal)
    torch.cuda.synchronize()
    assert _within(old, exp, fops.TOLERANCE[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,sq,sk,d,causal", [
    (8, 24, 8, 1, 1024, 64, False),       # the granite serve's decode
    (3, 6, 2, 1, 300, 12, False),         # ragged head_dim, a short split
    (2, 4, 4, 4, 500, 128, True)])        # 4 rows a KV head, causal
def test_flash_attention_split_route(dev, dtype, b, h, kv, sq, sk, d, causal):
    """Decode's rows over a long cache: the live prefix split over
    blocks, combined in a fixed order in the same launch."""
    from repro_torch.kernels.flash_attention import ops as fops, ref as fref
    g = torch.Generator(device=dev).manual_seed(sk + d)
    mk = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
    q, k, v = mk(b, h, sq, d), mk(b, kv, sk, d), mk(b, kv, sk, d)
    lens = torch.randint(1, sk + 1, (b,), generator=g, device=dev,
                         dtype=torch.int32)
    lens[0], lens[-1] = sk, 40            # a full cache and one tile
    assert fops.route(q, k, v) == "split"
    before = dict(fops.flash_attention.by_route)
    got = fops.flash_attention(q, k, v, lens, causal)
    assert fops.flash_attention.by_route["split"] == before["split"] + 1
    exp = fref.mha_ref(q, k, v, lens, causal).to(dtype)
    torch.cuda.synchronize()
    assert _within(got, exp, fops.TOLERANCE[dtype])
    # the same bits again (the counters were left at 0), and with poisoned
    # keys past each length
    assert torch.equal(fops.flash_attention(q, k, v, lens, causal), got)
    k2, v2 = k.clone(), v.clone()
    for i, n in enumerate(lens.tolist()):
        k2[i, :, n:] = 1e4
        v2[i, :, n:] = -1e4
    assert torch.equal(fops.flash_attention(q, k2, v2, lens, causal), got)
    old = fops.run_route("simt", q, k, v, lens, causal)
    torch.cuda.synchronize()
    assert _within(old, exp, fops.TOLERANCE[dtype])


@pytest.mark.parametrize("route", ["split", "simt"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,sk,d", [
    (8, 24, 8, 1024, 64),                 # the granite serve's decode
    (8, 16, 8, 2048, 128),                # internvl2's
    (3, 6, 2, 300, 12)])                  # ragged head_dim
def test_flash_attention_partial_each_route(dev, route, dtype, b, h, kv, sk,
                                            d):
    """Decode's float32 output and row log-sum-exp on both routes against
    ``mha_ref_lse``: ``o`` within the float32 tolerance, ``lse`` within
    1e-5 relative (-inf exactly for a row of no live key), and ``o`` in
    the input's type within ``flash_attention``'s tolerance of its own
    output on the route."""
    from repro_torch.kernels.flash_attention import ops as fops, ref as fref
    g = torch.Generator(device=dev).manual_seed(sk + d + 1)
    mk = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
    q, k, v = mk(b, h, 1, d), mk(b, kv, sk, d), mk(b, kv, sk, d)
    lens = torch.randint(1, sk + 1, (b,), generator=g, device=dev,
                         dtype=torch.int32)
    lens[0], lens[-1] = 0, sk             # no live key, a full cache
    before = dict(fops.flash_attention_partial.by_route)
    o, lse = fops.run_route(route, q, k, v, lens, False, partial=True)
    assert fops.flash_attention_partial.by_route[route] == before[route] + 1
    exp_o, exp_lse = fref.mha_ref_lse(q, k, v, lens)
    torch.cuda.synchronize()
    assert o.dtype == lse.dtype == torch.float32
    assert _within(o, exp_o, fops.TOLERANCE[torch.float32])
    dead = torch.isinf(exp_lse)
    assert torch.equal(torch.isinf(lse), dead) and bool((lse[dead] < 0).all())
    assert bool(((lse - exp_lse).abs()[~dead]
                 <= 1e-5 * exp_lse.abs()[~dead].clamp_min(1.0)).all())
    assert torch.count_nonzero(o[0]) == 0
    whole = fops.run_route(route, q, k, v, lens, False)
    assert _within(o.to(dtype), whole, fops.TOLERANCE[dtype])
    if fops.route(q, k, v) == route:
        got = fops.flash_attention_partial(q, k, v, lens)
        assert all(torch.equal(x, y) for x, y in zip(got, (o, lse)))


def test_flash_attention_partial_refuses_prefill_rows(dev):
    from repro_torch.kernels.flash_attention import ops as fops
    q = torch.zeros((1, 4, 9, 64), device=dev)      # 18 rows a KV head
    k = torch.zeros((1, 2, 512, 64), device=dev)
    with pytest.raises(ValueError, match="query rows"):
        fops.run_route("split", q, k, k, None, False, partial=True)
    with pytest.raises(ValueError, match="causal"):
        fops.run_route("split", q[:, :, :1], k, k, None, True, partial=True)
    with pytest.raises(ValueError, match="routes are"):
        fops.run_route("wgmma", q[:, :, :1], k, k, None, False, partial=True)
    with pytest.raises(ValueError, match="query rows"):
        fops.flash_attention_partial(q, k, k)


def test_lm_kernels_refuse_what_they_do_not_take(dev):
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.wavefront_matmul import ops as mops
    q = torch.zeros((1, 1, 4, 160), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        fops.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        mops.wavefront_matmul(torch.zeros((4, 8), device=dev),
                              torch.zeros((8, 2), device=dev),
                              torch.ones(1, device="cpu"))


def test_lm_kernels_meta_route_beside_cuda(dev):
    """A ``meta`` tensor (the dry run's trace) takes each LM kernel's plain
    version, forward and backward, and launches nothing; a CUDA tensor
    that no route takes still raises."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.wavefront_matmul import ops as mops
    counts = lambda: (mops.wavefront_matmul.launches,
                      mops.wavefront_matmul.backward_launches,
                      fops.flash_attention.launches,
                      fops.flash_attention.backward_launches)
    before = counts()
    bf = torch.bfloat16
    q = torch.empty((8, 24, 512, 64), dtype=bf, device="meta",
                    requires_grad=True)
    k = torch.empty((8, 8, 512, 64), dtype=bf, device="meta",
                    requires_grad=True)
    o = fops.flash_attention(q, k, k)
    o.sum().backward()
    a = torch.empty((40, 820, 1536), dtype=bf, device="meta",
                    requires_grad=True)
    w = torch.empty((40, 1536, 512), dtype=bf, device="meta",
                    requires_grad=True)
    c = mops.wavefront_matmul(a, w, torch.ones((40, 7), dtype=torch.int32,
                                               device="meta"))
    c.sum().backward()
    assert o.device.type == c.device.type == "meta"
    assert q.grad.shape == q.shape and w.grad.shape == w.shape
    assert counts() == before
    x = torch.zeros((1, 1, 4, 160), dtype=bf, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        fops.flash_attention(x, x, x)
    assert counts() == before


@pytest.mark.parametrize("mode", ["expert_choice", "token_dense"])
def test_moe_and_attention_on_cuda_equal_cpu(dev, mode):
    """The modules on the card (kernels) against the port's CPU run
    (plain versions), float32, granite's smoke config."""
    from repro_torch import configs
    from repro_torch.models import attention, convert, moe
    cfg = configs.get_smoke("granite-moe-3b-a800m").replace(
        dtype=torch.float32)
    tree = convert.numpy_params(cfg, 0)
    sub = lambda name: {k: torch.from_numpy(v[0].copy())
                        for k, v in tree["blocks"][name].items()}
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 16, cfg.d_model))
                         .astype(np.float32))
    pos = torch.arange(16).expand(2, 16)
    mp, ap = sub("moe"), sub("attn")
    to = lambda p: {k: v.to(dev) for k, v in p.items()}
    exp = moe.moe_apply(cfg, mp, x, mode=mode)
    got = moe.moe_apply(cfg, to(mp), x.to(dev), mode=mode)
    assert torch.allclose(got.cpu(), exp, atol=2e-5)
    exp = attention.attend(cfg, ap, x, pos)
    got = attention.attend(cfg, to(ap), x.to(dev), pos.to(dev))
    assert torch.allclose(got.cpu(), exp, atol=2e-5)


def test_smoke_serve_on_cuda_holds_against_reference_file(dev):
    """The JAX reference's committed smoke serve, float32 and bfloat16."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.wavefront_matmul import ops as mops
    from repro_torch.launch import serve
    f0, m0 = fops.flash_attention.launches, mops.wavefront_matmul.launches
    out = serve.hold_against_reference(dev)
    assert out["float32"]["tokens_checked"] == out["float32"]["tokens"]
    assert fops.flash_attention.launches > f0
    assert mops.wavefront_matmul.launches > m0


# --- the other model families: zamba2, xlstm, seamless-m4t, internvl2 -------

FAMILY_ARCHS = ["zamba2-1p2b", "xlstm-350m", "seamless-m4t-large-v2",
                "internvl2-2b"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_smoke_serve_on_cuda_equals_cpu(dev, arch, dtype):
    """Each family's smoke serve (numpy weights and inputs) on the card,
    fed the CPU run's tokens, within the serve's tolerance of the port's
    CPU run; attention (none for xlstm) through the kernel."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch import serve
    serve.float32_matmuls()
    cfg = configs.get_smoke(arch).replace(dtype=serve.DTYPES[dtype])
    runs = {}
    f0 = fops.flash_attention.launches
    for d in (torch.device("cpu"), dev):
        model = serve.build_model(cfg, 0, d, "numpy")
        prompt, inputs = serve.make_inputs(cfg, 0, 4, 16, d)
        force = runs["cpu"]["tokens"] if "cpu" in runs else None
        runs[d.type] = serve.generate(cfg, model, prompt, 8, 64,
                                      inputs=inputs, force=force,
                                      keep_logits=True)
    got, exp = runs["cuda"]["logits"], runs["cpu"]["logits"]
    assert serve.tolerance_error(got, exp, dtype) is None
    assert serve.greedy_mismatches(got, exp, dtype)[0] == 0
    assert (fops.flash_attention.launches > f0) == (arch != "xlstm-350m")


def test_family_smoke_serves_on_cuda_hold_against_reference_file(dev):
    """The JAX reference's committed smoke serves of the four families."""
    from repro_torch.launch import serve
    serve.float32_matmuls()
    out = serve.hold_against_reference(dev, serve.REFERENCE_FAMILIES)
    assert sorted(out) == sorted(FAMILY_ARCHS)
    assert all(r["float32"]["max_abs_err"] <= 2e-5 for r in out.values())


@pytest.mark.parametrize("b,h,kv,sq,sk,d,causal,route", [
    (8, 16, 16, 512, 512, 64, False, "wgmma"),    # seamless's encoder
    (8, 16, 8, 1536, 1536, 128, True, "wgmma"),   # internvl2's prefill
    (8, 16, 16, 1, 512, 64, False, "split"),      # seamless's cross decode
    (8, 16, 8, 1, 2048, 128, False, "split")])    # internvl2's decode
def test_flash_attention_family_shapes_take_fast_routes(dev, b, h, kv, sq,
                                                        sk, d, causal, route):
    """The families' new call shapes, bf16, ragged lengths (one row of
    length 1), on the route each should take, against ``mha_ref``."""
    from repro_torch.kernels.flash_attention import ops as fops, ref as fref
    g = torch.Generator(device=dev).manual_seed(sq + sk + d)
    mk = lambda *s: torch.randn(s, generator=g, device=dev).bfloat16()
    q, k, v = mk(b, h, sq, d), mk(b, kv, sk, d), mk(b, kv, sk, d)
    lens = torch.randint(1, sk + 1, (b,), generator=g, device=dev,
                         dtype=torch.int32)
    lens[0], lens[-1] = sk, 1
    assert fops.route(q, k, v) == route
    before = dict(fops.flash_attention.by_route)
    got = fops.flash_attention(q, k, v, lens, causal)
    assert fops.flash_attention.by_route[route] == before[route] + 1
    assert fops.flash_attention.by_route["simt"] == before["simt"]
    exp = fref.mha_ref(q, k, v, lens, causal).bfloat16()
    torch.cuda.synchronize()
    assert _within(got, exp, fops.TOLERANCE[torch.bfloat16])


# --- the backward kernels and the training step -------------------------------

BWD_ATTN = [(8, 24, 8, 511, 511, 64, True),   # the granite training call
            (2, 2, 2, 128, 128, 64, True),    # G = 1
            (2, 6, 2, 37, 37, 12, True),      # G = 3, ragged head_dim
            (2, 4, 1, 100, 300, 128, True),   # G = 4, Sk > Sq, head_dim 128
            (2, 8, 2, 200, 200, 64, False),
            (3, 24, 8, 1, 1024, 64, False),   # decode's one row
            (2, 4, 4, 16, 48, 16, False)]


def _attn_args(dev, dtype, b, h, kv, sq, sk, d, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
    q, k, v, do = mk(b, h, sq, d), mk(b, kv, sk, d), mk(b, kv, sk, d), \
        mk(b, h, sq, d)
    lens = torch.randint(1, sk + 1, (b,), generator=g, device=dev,
                         dtype=torch.int32)
    lens[0] = sk
    return q, k, v, do, lens


def _bwd_routes(cases):
    """(dtype, backward route, *case) for each backward route that takes
    the case: ``simt`` all, ``wgmma`` bfloat16 with head_dim a multiple of
    16 up to ``BWD_WGMMA_HEAD_DIM`` (fresh tensors are TMA-legal)."""
    from repro_torch.kernels.flash_attention import ops as fops
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for case in cases:
            d = case[5]
            for route in fops.BWD_ROUTES:
                if route == "simt" or (dtype == torch.bfloat16 and d % 16 == 0
                                       and d <= fops.BWD_WGMMA_HEAD_DIM):
                    out.append((dtype, route, *case))
    return out


@pytest.mark.parametrize("dtype,route,b,h,kv,sq,sk,d,causal",
                         _bwd_routes(BWD_ATTN))
def test_flash_attention_backward_kernel_equals_plain(dev, dtype, route, b, h,
                                                      kv, sq, sk, d, causal):
    """Each backward route's dq, dk, dv within ``BWD_TOLERANCE`` of
    ``mha_ref_bwd``; keys past each length get zero dk, dv and change no
    bit of dq; two runs are bit-identical; one launch of each kernel on
    that route, counted apart from the forward's."""
    q, k, v, do, lens = _attn_args(dev, dtype, b, h, kv, sq, sk, d,
                                   sq + sk + d)
    _check_attention_bwd(q, k, v, do, lens, causal, route)


#: rows with no live key: (B, H, KV, Sq, Sk, D, causal, lengths), a batch
#: entry of length 0, and causal with Sq > Sk (the first Sq - Sk rows)
BWD_ATTN_DEAD = [(3, 6, 2, 70, 70, 64, True, (70, 0, 33)),
                 (3, 8, 2, 130, 100, 32, False, (0, 100, 41)),
                 (2, 4, 1, 150, 90, 64, True, (90, 57)),
                 (2, 6, 3, 100, 37, 12, True, (37, 0))]


@pytest.mark.parametrize("dtype,route,b,h,kv,sq,sk,d,causal,lengths",
                         _bwd_routes(BWD_ATTN_DEAD))
def test_flash_attention_backward_rows_without_live_keys(dev, dtype, route, b,
                                                         h, kv, sq, sk, d,
                                                         causal, lengths):
    """A row that sees no key gets a zero output and a zero dq; the keys
    of a length-0 entry get zero dk, dv; the rest as above, each route."""
    q, k, v, do, _ = _attn_args(dev, dtype, b, h, kv, sq, sk, d, sq + sk)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    o, dq = _check_attention_bwd(q, k, v, do, lens, causal, route)
    for i, n in enumerate(lengths):
        dead = sq if n == 0 else (max(0, sq - sk) if causal else 0)
        assert not torch.count_nonzero(o[i, :, :dead])
        assert not torch.count_nonzero(dq[i, :, :dead])
    assert any(n == 0 for n in lengths) or (causal and sq > sk)


def _bwd_moved(before):
    """The backward launches since ``before``, by kernel and route."""
    from repro_torch.kernels.flash_attention import ops as fops
    return {kn: {r: c - before[kn][r] for r, c in rs.items()}
            for kn, rs in fops.flash_attention.backward_by_route.items()}


def _bwd_counts():
    from repro_torch.kernels.flash_attention import ops as fops
    return {kn: dict(rs) for kn, rs in
            fops.flash_attention.backward_by_route.items()}


def _check_attention_bwd(q, k, v, do, lens, causal, route):
    """Backward route ``route``'s kernels against ``mha_ref_bwd`` (see
    the tests above); returns the forward's output and the kernels'
    dq."""
    from repro_torch.kernels.flash_attention import ops as fops, ref as fref
    dtype = q.dtype
    o = fops.flash_attention(q, k, v, lens, causal)
    fwd = fops.flash_attention.launches
    before = _bwd_counts()
    run = lambda k_, v_: fops.run_bwd_route(route, q, k_, v_, o, do, lens,
                                            causal)
    got = run(k, v)
    assert fops.flash_attention.launches == fwd
    one = {r: int(r == route) for r in fops.BWD_ROUTES}
    assert _bwd_moved(before) == {"dq": one, "dkdv": one}
    exp = fref.mha_ref_bwd(q, k, v, o, do, lens, causal)
    again = run(k, v)
    torch.cuda.synchronize()
    for x, y, z in zip(got, exp, again):
        assert x.dtype == dtype
        assert _within(x, y, fops.BWD_TOLERANCE[dtype])
        assert torch.equal(x, z)
    k2, v2 = k.clone(), v.clone()
    for i, n in enumerate(lens.tolist()):
        k2[i, :, n:] = 1e4
        v2[i, :, n:] = -1e4
    p = run(k2, v2)
    assert torch.equal(p[0], got[0])
    for i, n in enumerate(lens.tolist()):
        assert not torch.count_nonzero(p[1][i, :, n:])
        assert not torch.count_nonzero(p[2][i, :, n:])
    return o, got[0]


def test_flash_attention_autograd_on_cuda(dev):
    """Through ``torch.autograd``: the forward kernel, then the backward
    kernels, bfloat16 on the ``wgmma`` route; under ``no_grad`` no
    Function is taken."""
    from repro_torch.kernels.flash_attention import ops as fops, ref as fref
    q, k, v, do, lens = _attn_args(dev, torch.bfloat16, 2, 6, 2, 64, 64, 64,
                                   1)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    with torch.no_grad():
        assert fops.flash_attention(qg, kg, vg, lens).grad_fn is None
    b0, before = fops.flash_attention.backward_launches, _bwd_counts()
    o = fops.flash_attention(qg, kg, vg, lens)
    got = torch.autograd.grad(o, (qg, kg, vg), do)
    assert fops.flash_attention.backward_launches == b0 + 2
    on_wgmma = {"wgmma": 1, "simt": 0}
    assert _bwd_moved(before) == {"dq": on_wgmma, "dkdv": on_wgmma}
    exp = fref.mha_ref_bwd(q, k, v, o.detach(), do, lens, True)
    torch.cuda.synchronize()
    for x, y in zip(got, exp):
        assert _within(x, y, fops.BWD_TOLERANCE[torch.bfloat16])


@pytest.mark.parametrize("dtype,e,m,k,n,da_route,db_route", [
    # the granite training GEMMs: capacity 818 rows, read in place
    (torch.bfloat16, 40, 818, 1536, 512, "wgmma", "wgmma"),
    (torch.bfloat16, 40, 818, 512, 1536, "wgmma", "wgmma"),
    (torch.bfloat16, 5, 9, 48, 64, "wgmma", "wgmma"),
    (torch.float32, 5, 9, 48, 64, "small_m", "simt"),
    (torch.float32, 3, 300, 160, 96, "simt", "simt"),
    # K = 100: A's rows are not 16-byte rows, so the copies on simt
    (torch.bfloat16, 3, 300, 100, 64, "simt", "simt")])
def test_wavefront_matmul_gradient_each_route(dev, dtype, e, m, k, n,
                                              da_route, db_route):
    """Both gradient products on the kernel, counted apart by product and
    route, against the plain backward; inactive tiles' dA zero."""
    from repro_torch.kernels.wavefront_matmul import ops as mops, ref as mref
    g = torch.Generator(device=dev).manual_seed(e + m + k + n)
    a = torch.randn((e, m, k), generator=g, device=dev).to(dtype)
    b = (torch.randn((e, k, n), generator=g, device=dev) / k ** 0.5).to(dtype)
    dc = torch.randn((e, m, n), generator=g, device=dev).to(dtype)
    act = torch.randint(0, 2, (e, -(-m // 128)), generator=g, device=dev,
                        dtype=torch.int32)
    act[0] = 1
    fwd = mops.wavefront_matmul.launches
    before = {p: dict(r) for p, r in
              mops.wavefront_matmul.backward_by_route.items()}
    da, db = mops.matmul_bwd(a, b, act, dc)
    assert mops.wavefront_matmul.launches == fwd
    moved = {p: {r: c - before[p][r] for r, c in v.items() if c > before[p][r]}
             for p, v in mops.wavefront_matmul.backward_by_route.items()}
    assert moved == {"da": {da_route: 1}, "db": {db_route: 1}}
    eda, edb = mref.wavefront_matmul_ref_bwd(a, b, act, dc)
    torch.cuda.synchronize()
    tol = mops.TOLERANCE[dtype]
    assert _within(da, eda, tol)
    assert _within(db, edb, (tol[0] * m ** 0.5, tol[1]))
    assert torch.count_nonzero(da[~mref.tile_mask(act, m)]) == 0


def _grad_inputs(dev, e, m, k, n, seed, idle=True):
    """bf16 A, B, dC and random ``row_active`` (expert 0 all live; with
    ``idle``, the last expert none)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    a = torch.randn((e, m, k), generator=g, device=dev).to(bf)
    b = (torch.randn((e, k, n), generator=g, device=dev) / k ** 0.5).to(bf)
    dc = torch.randn((e, m, n), generator=g, device=dev).to(bf)
    act = torch.randint(0, 2, (e, -(-m // 128)), generator=g, device=dev,
                        dtype=torch.int32)
    act[0] = 1
    if idle and e > 1:
        act[-1] = 0
    return a, b, act, dc


@pytest.mark.parametrize("e,m,k,n,idle", [
    (40, 818, 1536, 512, False), (40, 818, 512, 1536, False),
    (40, 818, 1536, 512, True), (5, 9, 48, 64, True),
    (3, 300, 104, 64, True), (3, 300, 100, 64, True), (1, 130, 8, 8, False)])
def test_wavefront_matmul_gradient_in_place(dev, e, m, k, n, idle):
    """The routed gradient against the plain backward (granite's two
    training shapes, ragged ones, random ``row_active``, an expert with no
    live tile): inactive tiles' dA and the idle expert's dB exactly zero;
    where the in-place kernel takes the operands, each product alone bit
    for bit the one launch's, and the ``"copies"`` route (the previous
    design) within ``TOLERANCE`` of it."""
    from repro_torch.kernels.wavefront_matmul import ops as mops, ref as mref
    a, b, act, dc = _grad_inputs(dev, e, m, k, n, e + m + k + n, idle)
    da, db = mops.matmul_bwd(a, b, act, dc)
    eda, edb = mref.wavefront_matmul_ref_bwd(a, b, act, dc)
    tol = mops.TOLERANCE[torch.bfloat16]
    tol_db = (tol[0] * m ** 0.5, tol[1])
    torch.cuda.synchronize()
    assert _within(da, eda, tol) and _within(db, edb, tol_db)
    assert torch.count_nonzero(da[~mref.tile_mask(act, m)]) == 0
    if idle and e > 1:
        assert torch.count_nonzero(db[-1]) == 0
    if mops.route_bwd(a, b, dc)[0] != "wgmma":
        assert k % 8                      # only the K = 100 case
        return
    alone_a, none_b = mops.run_bwd_route("wgmma", a, b, act, dc, ("da",))
    none_a, alone_b = mops.run_bwd_route("wgmma", a, b, act, dc, ("db",))
    cda, cdb = mops.run_bwd_route("copies", a, b, act, dc)
    torch.cuda.synchronize()
    assert none_a is None and none_b is None
    assert torch.equal(alone_a, da) and torch.equal(alone_b, db)
    assert _within(cda, da, tol) and _within(cdb, db, tol_db)


def test_wavefront_matmul_gradient_launches_by_route(dev):
    """One launch of the in-place kernel counts each product once on
    ``wgmma``; the ``"copies"`` route two launches of the forward's
    ``wgmma`` kernel, counted as ``"copies"``; the forward's counters do
    not move."""
    from repro_torch.kernels.wavefront_matmul import ops as mops
    a, b, act, dc = _grad_inputs(dev, 4, 300, 64, 48, 3)
    f = mops.wavefront_matmul

    def moved(fn):
        before = (f.launches, f.backward_launches,
                  {p: dict(r) for p, r in f.backward_by_route.items()})
        fn()
        return (f.launches - before[0], f.backward_launches - before[1],
                {p: {r: c - before[2][p][r] for r, c in v.items()
                     if c != before[2][p][r]}
                 for p, v in f.backward_by_route.items()})

    one = {"da": {"wgmma": 1}, "db": {"wgmma": 1}}
    assert moved(lambda: mops.matmul_bwd(a, b, act, dc)) == (0, 1, one)
    assert moved(lambda: mops.run_bwd_route("wgmma", a, b, act, dc,
                                            ("db",))) == \
        (0, 1, {"da": {}, "db": {"wgmma": 1}})
    assert moved(lambda: mops.run_bwd_route("copies", a, b, act, dc)) == \
        (0, 2, {"da": {"copies": 1}, "db": {"copies": 1}})
    ag, bg = a.clone().requires_grad_(), b.clone().requires_grad_()
    assert moved(lambda: mops.wavefront_matmul(ag, bg, act).backward(dc)) \
        == (1, 1, one)


def test_wavefront_matmul_gradient_allocates_outputs_only(dev):
    """At granite's up shape one call's allocator growth (requested
    bytes) is dA + dB: no copy of A, B or dC, as ``workspace_bytes``
    says."""
    from repro_torch.kernels.wavefront_matmul import ops as mops
    a, b, act, dc = _grad_inputs(dev, 40, 818, 1536, 512, 11, idle=False)
    mops.matmul_bwd(a, b, act, dc)           # built and warm
    torch.cuda.synchronize()
    key = "requested_bytes.all"
    base = torch.cuda.memory_stats(dev)[f"{key}.current"]
    torch.cuda.reset_peak_memory_stats(dev)
    da, db = mops.matmul_bwd(a, b, act, dc)
    torch.cuda.synchronize()
    growth = torch.cuda.memory_stats(dev)[f"{key}.peak"] - base
    outputs = (da.numel() + db.numel()) * da.element_size()
    assert growth <= outputs
    assert mops.workspace_bytes(
        torch.ops.repro_torch.wavefront_matmul_bwd.default, a, b) == 0


def test_smoke_train_step_on_cuda_equals_cpu(dev):
    """One step of granite's smoke config, float32, the same numpy weights
    and batch on the card (kernels forward and backward) and on the CPU
    (plain versions): the loss, gradient norm and every updated parameter
    within float32 rounding of the sums' order."""
    _train_step_on_cuda_equals_cpu(dev, "granite-moe-3b-a800m")


@pytest.mark.parametrize("arch", ["zamba2-1p2b", "xlstm-350m",
                                  "seamless-m4t-large-v2", "internvl2-2b"])
def test_family_smoke_train_step_on_cuda_equals_cpu(dev, arch):
    """The same for the other families (frames and patches on the card
    with the tokens)."""
    _train_step_on_cuda_equals_cpu(dev, arch)


def _train_step_on_cuda_equals_cpu(dev, arch):
    from repro_torch import configs
    from repro_torch.launch import serve, train
    from repro_torch.training import data, optimizer
    from repro_torch.training.steps import make_train_step
    serve.float32_matmuls()
    cfg = configs.get_smoke(arch).replace(dtype=torch.float32)
    ocfg = optimizer.OptConfig(lr=1e-3, warmup_steps=2, total_steps=4)
    batch = data.SyntheticLM(cfg, 4, 32).next_batch(0)
    out = {}
    for where in ("cpu", dev):
        model = train.build_model(cfg, 0, torch.device(where), "numpy")
        opt = optimizer.init(dict(model.named_parameters()), ocfg)
        b = {k: torch.from_numpy(v).to(where) for k, v in batch.items()}
        model, opt, _, m = make_train_step(cfg, ocfg)(model, opt, b, None)
        out[str(where)] = (m, {k: p.detach().cpu() for k, p in
                               model.named_parameters()})
    (mc, pc), (mg, pg) = out["cpu"], out[str(dev)]
    for key in ("loss", "grad_norm", "lr"):
        assert abs(float(mg[key]) - float(mc[key])) <= 1e-5 * abs(
            float(mc[key]))
    for k in pc:
        # an element whose gradient is near zero moves by up to about lr
        # either way under AdamW's normalisation
        assert torch.allclose(pg[k], pc[k], atol=2e-3, rtol=0), k


# ---------------------------------------------------------------------------
# The compiled tiers (core/blockc.py): units replayed as CUDA graphs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["blocks", "superblock", "auto"])
def test_compiled_tiers_on_cuda_equal_cpu(dev, mode):
    """Every suite job of the dp and nopred configurations through the
    graph-replayed tiers equals the CPU run leaf for leaf; the graphs'
    step launches equal the card's ``run_program``'s, none on ``tile``,
    and a run replays one graph per unit of the plan's order."""
    from repro_torch.core import compile_program, run_compiled
    for name in ("dp", "nopred"):
        for b in tp.suite(tprog, tp.config(EGPUConfig, name)).values():
            kw = dict(shared_init=b.shared_init, tdx_dim=b.tdx_dim)
            exp = state_to_numpy(run_compiled(b.image, mode=mode,
                                              device="cpu", **kw))
            c0 = (wops.wavefront_alu.by_route["step"],
                  dops.dot_product.by_route["step"])
            run_program(b.image, device=dev, **kw)
            c1 = (wops.wavefront_alu.by_route["step"],
                  dops.dot_product.by_route["step"])
            t0 = (wops.wavefront_alu.by_route["tile"],
                  dops.dot_product.by_route["tile"])
            cp = compile_program(b.image, mode=mode)
            cp.light_compile(np.zeros(cp.cfg.shared_words, np.uint32),
                             b.tdx_dim, dev)
            c2 = (wops.wavefront_alu.by_route["step"],
                  dops.dot_product.by_route["step"])
            got = run_compiled(b.image, mode=mode, device=dev, **kw)
            c3 = (wops.wavefront_alu.by_route["step"],
                  dops.dot_product.by_route["step"])
            tp.assert_leaves_equal(exp, state_to_numpy(got),
                                   f"{name}/{b.name}/{mode}")
            assert [y - x for x, y in zip(c2, c3)] \
                == [y - x for x, y in zip(c0, c1)], b.name
            assert t0 == (wops.wavefront_alu.by_route["tile"],
                          dops.dot_product.by_route["tile"])
            gs = cp.graph_stats(dev)
            assert gs["replays"] == len(cp._unit_order()), b.name
            assert gs["graphs"] == len(set(cp._unit_order())), b.name


def test_compiled_batch_and_light_path_on_cuda(dev):
    """A lock-step batch with four TDX grids equals the CPU batch; the
    light path leaves its input unchanged, replays to the same result,
    and returns a fresh tensor."""
    from repro_torch.core import compile_program
    b = tprog.build_matmul(tp.config(EGPUConfig, "dp"), 8)
    rng = np.random.default_rng(5)
    n = np.asarray(b.shared_init).size
    inits = [b.shared_init] + [rng.standard_normal(n).astype(np.float32)
                               for _ in range(3)]
    tdx = [b.tdx_dim, 4, 16, 32]
    for mode in ("blocks", "superblock"):
        cp = compile_program(b.image, mode=mode)
        exp = state_to_numpy(cp.run_batch(inits, tdx, device="cpu"))
        got = state_to_numpy(cp.run_batch(inits, tdx, device=dev))
        tp.assert_leaves_equal(exp, got, f"batch/{mode}")
        sh = torch.from_numpy(np.stack([
            np.pad(np.asarray(s, np.float32).view(np.int32),
                   (0, cp.cfg.shared_words - n)) for s in inits])).to(dev)
        keep = sh.clone()
        td = torch.tensor(tdx, dtype=torch.int32, device=dev)
        first = cp.run_light_dev(sh, td)[0]
        second = cp.run_light_dev(sh, td)[0]
        torch.cuda.synchronize()
        assert torch.equal(sh, keep)
        assert torch.equal(first, second)
        assert first.data_ptr() != second.data_ptr()
        assert np.array_equal(first.cpu().numpy().view(np.uint32),
                              exp["shared"])


# ---------------------------------------------------------------------------
# Coverage: every configuration and generated programs, every path
# ---------------------------------------------------------------------------

def _coverage_jobs(name):
    """The suite of this configuration plus four generated programs
    (clean and hostile), as ``(label, image, init keywords)``."""
    from repro_torch.programs.generator import generate_program
    cfg = tp.config(EGPUConfig, name)
    out = [(b.name, b.image, dict(shared_init=b.shared_init,
                                  tdx_dim=b.tdx_dim))
           for b in tp.suite(tprog, cfg).values()]
    for k, (seed, h) in enumerate(((200, 0.0), (201, 0.0), (202, 1.0),
                                   (203, 1.0))):
        data = np.random.default_rng(seed).integers(
            0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
        out.append((f"gen{seed}-{h}", generate_program(cfg, seed,
                                                       hostility=h),
                    dict(shared_init=data, tdx_dim=(4, 8, 16, 32)[k])))
    return out


@pytest.mark.parametrize("name", sorted(tp.CONFIGS))
def test_every_path_on_cuda_equals_cpu(dev, name):
    """``run_program``, a heterogeneous ``fleet_run``, the three
    compiled tiers (a program the compiler rejects takes the
    interpreter) and a ``Fleet`` drain on the card, each equal to the
    port's CPU run leaf for leaf, in all four CONFIGS and on generated
    programs."""
    from repro_torch.analysis import ProgramVerificationError
    from repro_torch.core import run_compiled
    from repro_torch.core.blockc import default_policy_for_device
    from repro_torch.fleet import Fleet
    jobs = _coverage_jobs(name)
    cpu = {}
    for label, img, kw in jobs:
        cpu[label] = state_to_numpy(run_program(img, device="cpu", **kw))
        tp.assert_leaves_equal(
            cpu[label], state_to_numpy(run_program(img, device=dev, **kw)),
            f"run_program {name}/{label}")
        for mode in ("blocks", "superblock", "auto"):
            got = run_compiled(img, mode=mode, device=dev, **kw)
            tp.assert_leaves_equal(cpu[label], state_to_numpy(got),
                                   f"{mode} {name}/{label}")
    out = fleet_run([img for _, img, _ in jobs],
                    init_kw=[kw for _, _, kw in jobs], device=dev)
    for k, (label, _, _) in enumerate(jobs):
        tp.assert_leaves_equal(cpu[label],
                               state_to_numpy(unstack_state(out, k)),
                               f"fleet_run {name}/{label}")
    cfg = tp.config(EGPUConfig, name)
    policy = default_policy_for_device(dev)      # one routing on both
    fleets = [Fleet(cfg, batch_size=4, tier_policy=policy, device=d)
              for d in ("cpu", dev)]
    results = []
    for fl in fleets:
        for label, img, kw in jobs * 2:
            try:
                fl.submit(img, kw["shared_init"], tdx_dim=kw["tdx_dim"],
                          tag=label)
            except ProgramVerificationError:
                assert label.startswith("gen"), label   # the lint's call
        results.append(fl.drain())
    assert sorted(results[0]) == sorted(results[1])
    for h, r in results[0].items():
        g = results[1][h]
        assert (g.tag, g.tier, g.cycles, g.steps, g.hazard_violations) \
            == (r.tag, r.tier, r.cycles, r.steps, r.hazard_violations), h
        assert np.array_equal(g.shared, r.shared), f"Fleet {name}/{r.tag}"
        assert np.array_equal(g.stat_cycles, r.stat_cycles)
        assert np.array_equal(g.stat_instrs, r.stat_instrs)
        assert np.array_equal(
            cpu[r.tag]["shared"], g.shared), f"Fleet vs run {r.tag}"
    assert fleets[1].stats.compiled_batches == \
        fleets[0].stats.compiled_batches > 0
    assert fleets[1].stats.degraded_units == 0
    # the sharded fleet over every card, and the serving loop on the card
    sharded = Fleet(cfg, batch_size=4, tier_policy=policy, devices="all")
    admitted = [(label, img, kw) for label, img, kw in jobs * 2
                if label in {r.tag for r in results[0].values()}]
    for label, img, kw in admitted:
        sharded.submit(img, kw["shared_init"], tdx_dim=kw["tdx_dim"],
                       tag=label)
    for h, g in sharded.drain().items():
        r = results[0][h]
        assert (g.tag, g.tier, g.cycles, g.steps) \
            == (r.tag, r.tier, r.cycles, r.steps), h
        assert np.array_equal(g.shared, r.shared), f"sharded {name}/{r.tag}"
    served = serve_jobs(cfg, [dict(image=img, tdx_dim=kw["tdx_dim"],
                                   shared_init=kw["shared_init"], tag=label)
                              for label, img, kw in admitted],
                        batch_size=4, max_delay_s=0.001, device=dev)
    for (label, _, _), g in zip(admitted, served):
        assert not isinstance(g, Exception), f"served {name}/{label}: {g}"
        exp = cpu[label]
        assert (g.cycles, g.steps, g.hazard_violations) == (
            int(exp["cycles"]), int(exp["steps"]),
            int(exp["hazard_violations"])), label
        assert np.array_equal(g.shared, exp["shared"]), f"served {label}"
        assert np.array_equal(g.stat_cycles, exp["stat_cycles"]), label


# ---------------------------------------------------------------------------
# One plan from several threads, and a capture beside them
# ---------------------------------------------------------------------------

def test_plan_threads_and_capture_beside_a_synchronise(dev):
    """Four threads, each on its own current stream (from the
    high-priority pool, which no plan draws its stream from), run one
    compiled program's plan through ``run_light_dev``
    and ``run_batch`` with their own inputs, every output equal to the
    CPU run; meanwhile one
    thread captures plans of another program (new batch widths) while
    another synchronises its stream and copies to the host in a loop,
    as a drain does.  The captures must not fail and their runs must
    equal the CPU's."""
    import threading
    from repro_torch.core import compile_program
    from repro_torch.core.machine import sync
    cfg = tp.config(EGPUConfig, "dp")
    mm = tprog.build_matmul(cfg, 8)
    other = tprog.build_bitonic(cfg, 16)
    n = np.asarray(mm.shared_init).size
    rng = np.random.default_rng(3)
    inits = [rng.standard_normal(n).astype(np.float32) for _ in range(8)]
    tdx = [4, 8, 16, 32] * 2
    cp = compile_program(mm.image, mode="superblock")
    cp._plans.clear()                    # the racing threads make it
    exp = state_to_numpy(cp.run_batch(inits, tdx, device="cpu"))
    cp2 = compile_program(other.image, mode="blocks")
    cp2._plans.clear()                   # captured beside the others
    errors, stop = [], threading.Event()

    def worker(k):
        rows = [2 * k, 2 * k + 1]
        mine = [inits[i] for i in rows]
        tdxs = [tdx[i] for i in rows]
        try:
            with torch.cuda.stream(torch.cuda.Stream(dev, priority=-1)):
                for r in range(20):
                    if r % 2:
                        got = state_to_numpy(cp.run_batch(mine, tdxs,
                                                          device=dev))
                        for j, i in enumerate(rows):
                            for f, v in got.items():
                                assert np.array_equal(v[j], exp[f][i]), \
                                    (k, r, f)
                    else:
                        out = cp.run_batch_light(mine, tdxs, device=dev)[0]
                        words = out.cpu().numpy().view(np.uint32)
                        for j, i in enumerate(rows):
                            assert np.array_equal(words[j],
                                                  exp["shared"][i]), (k, r)
        except Exception as e:           # noqa: BLE001 — reported below
            errors.append(e)

    def capture():
        try:
            for b in (1, 3, 5):
                cp2.light_compile(np.zeros((b, cfg.shared_words), np.uint32),
                                  np.full(b, 16, np.int32), dev)
        except Exception as e:           # noqa: BLE001 — reported below
            errors.append(e)

    def synchronise():
        x = torch.ones(1024, device=dev)
        while not stop.is_set():
            (x + 1).cpu()
            sync(dev)

    ths = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    ths += [threading.Thread(target=capture)]
    syncer = threading.Thread(target=synchronise)
    syncer.start()
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=600)
    stop.set()
    syncer.join(timeout=60)
    assert not any(th.is_alive() for th in ths + [syncer])
    assert not errors, errors[0]
    assert sorted(b for d, b in cp._plans if d.type == "cuda") == [2]
    cpu = state_to_numpy(cp2.run_batch([other.shared_init] * 3, [16] * 3,
                                       device="cpu"))
    got = state_to_numpy(cp2.run_batch([other.shared_init] * 3, [16] * 3,
                                       device=dev))
    tp.assert_leaves_equal(cpu, got, "captured beside a synchronise")


# ---------------------------------------------------------------------------
# The copy down into page-locked host memory (fleet/scheduler._download)
# ---------------------------------------------------------------------------

def _down_jobs(cfg, seed, n=8):
    """A reduction program and ``n`` fresh inputs for it."""
    b = tprog.build_reduction(cfg, 32)
    rng = np.random.default_rng(seed)
    size = np.asarray(b.shared_init).size
    return b, [rng.standard_normal(size).astype(np.float32)
               for _ in range(n)]


def _down_drain(sched, b, datas):
    hs = [sched.submit(b.image, d, tdx_dim=b.tdx_dim) for d in datas]
    rs = sched.drain()
    return [rs[h] for h in hs]


def _downloads(tracer):
    return [e["args"] for e in tracer.events
            if e.get("name") == "download" and e.get("ph") == "X"]


def test_download_lands_in_pinned_memory_as_a_cpu_copy(dev):
    """One card's image and a megabatch's shards come down into one
    page-locked tensor equal word for word to ``.cpu()`` copies; a
    ``Fleet`` drain and a sharded megabatch on the card equal the CPU
    scheduler's results."""
    from repro_torch.fleet import FleetScheduler, ShardedFleetScheduler
    from repro_torch.fleet import scheduler as sched_mod
    g = torch.Generator(device=dev).manual_seed(7)
    shards = [torch.randint(-2**31, 2**31 - 1, (rows, 1024), generator=g,
                            dtype=torch.int32, device=dev)
              for rows in (4, 3, 5)]
    for outs in (shards[:1], shards):
        img, host = sched_mod._download(outs)
        assert host == "pinned" and img.is_pinned()
        assert img.device.type == "cpu"
        assert torch.equal(img, torch.cat([o.cpu() for o in outs]))
    cfg = tp.config(EGPUConfig, "dp")
    b, datas = _down_jobs(cfg, 1)
    exp = _down_drain(FleetScheduler(cfg, 4, device="cpu"), b, datas)
    for sched in (FleetScheduler(cfg, 4, device=dev),
                  ShardedFleetScheduler(cfg, batch_size=4,
                                        devices=[torch.device("cuda", 0)])):
        got = _down_drain(sched, b, datas)
        for r, x in zip(got, exp):
            assert np.array_equal(r.shared, x.shared)
            assert (r.cycles, r.steps) == (x.cycles, x.steps)
    assert sched.stats.per_device()["mesh"]["jobs"] == len(datas)


def test_download_counts_pinned_bytes(dev):
    """Each batch's ``download`` span carries ``pinned_bytes`` equal to
    its ``bytes``, and the counter's ``pinned`` label grows by
    B x S x 4 a batch."""
    from repro_torch.fleet import FleetScheduler
    cfg = tp.config(EGPUConfig, "dp")
    b, datas = _down_jobs(cfg, 2)
    sched = FleetScheduler(cfg, 4, device=dev, trace=True)
    reg = sched.stats.registry
    per_batch = 4 * cfg.shared_words * 4
    for k in (1, 2):
        _down_drain(sched, b, datas)
        assert reg.value("fleet_download_bytes_total", host="pinned") \
            == 2 * k * per_batch
    assert reg.value("fleet_download_bytes_total", host="pageable") == 0
    downs = _downloads(sched.tracer)
    assert len(downs) == 4
    assert all(a["pinned_bytes"] == a["bytes"] == per_batch for a in downs)


def test_download_falls_back_to_pageable_memory(dev, monkeypatch):
    """A page-locked allocation that raises costs the batch its pinned
    copy, never its results: they equal the CPU's, and the bytes count
    under ``pageable``."""
    from repro_torch.fleet import FleetScheduler
    from repro_torch.fleet import scheduler as sched_mod

    def refuse(shape):
        raise RuntimeError("page-locked allocation refused")

    monkeypatch.setattr(sched_mod, "_pinned_empty", refuse)
    cfg = tp.config(EGPUConfig, "dp")
    b, datas = _down_jobs(cfg, 3)
    exp = _down_drain(FleetScheduler(cfg, 4, device="cpu"), b, datas)
    sched = FleetScheduler(cfg, 4, device=dev, trace=True)
    got = _down_drain(sched, b, datas)
    for r, x in zip(got, exp):
        assert np.array_equal(r.shared, x.shared)
    reg = sched.stats.registry
    assert reg.value("fleet_download_bytes_total", host="pageable") \
        == 2 * 4 * cfg.shared_words * 4
    assert reg.value("fleet_download_bytes_total", host="pinned") == 0
    assert all(a["pinned_bytes"] == 0 for a in _downloads(sched.tracer))


def test_held_results_survive_later_drains_on_the_card(dev):
    """The results of drain k, still held, are unchanged after drains
    k+1 and k+2 of other inputs, whose page-locked images come from the
    same allocator."""
    from repro_torch.fleet import FleetScheduler
    cfg = tp.config(EGPUConfig, "dp")
    sched = FleetScheduler(cfg, 4, device=dev)
    b, datas = _down_jobs(cfg, 4)
    held = _down_drain(sched, b, datas)
    words = [r.shared.copy() for r in held]
    for seed in (5, 6):
        later = _down_drain(sched, b, _down_jobs(cfg, seed)[1])
        assert any(not np.array_equal(x.shared, y.shared)
                   for x, y in zip(held, later))
        del later
    for k, (r, w) in enumerate(zip(held, words)):
        assert np.array_equal(r.shared, w), k


def test_dropped_results_reuse_the_pinned_blocks(dev):
    """With each drain's results dropped before the next, the caching
    host allocator makes no new page-locked block after the first
    drain."""
    from repro_torch.fleet import FleetScheduler
    cfg = tp.config(EGPUConfig, "dp")
    sched = FleetScheduler(cfg, 4, device=dev)
    b = _down_jobs(cfg, 7)[0]
    _down_drain(sched, b, _down_jobs(cfg, 8)[1])
    n0 = torch.cuda.host_memory_stats()["num_host_alloc"]
    for seed in (9, 10, 11):
        res = _down_drain(sched, b, _down_jobs(cfg, seed)[1])
        del res
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == n0
