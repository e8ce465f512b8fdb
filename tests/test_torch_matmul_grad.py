"""The expert GEMM's gradient (``wavefront_matmul``'s ``matmul_bwd``) on
the CPU: its plain version against ``jax.vjp`` of the reference's
``repro.kernels.wavefront_matmul.ref.wavefront_matmul_ref``, expert by
expert, and the rules around the CUDA kernels that compute it on the
card (``route_bwd``, ``workspace_bytes``, the ``meta`` fake, what a CPU
tensor given to a kernel route does).

Inputs are made from a numpy seed: ragged M (9, 130, 300 rows), K and N
multiples of 8 but not of 128, random ``row_active`` with one expert
that has no live tile, float32 and bfloat16.  Tolerance: ``ops.
TOLERANCE`` of the type (both sides sum in float32 in other orders;
bfloat16 rounds once, so one ulp apart at most), dB's atol scaled by
sqrt(M), as dB sums M products where the forward sums K.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.wavefront_matmul import ref as rref  # noqa: E402
from repro_torch.kernels.wavefront_matmul import ops as mops, ref as mref  # noqa: E402

BWD = torch.ops.repro_torch.wavefront_matmul_bwd.default
FWD = torch.ops.repro_torch.wavefront_matmul.default
BF = torch.bfloat16
#: (E, M, K, N): ragged M, K and N multiples of 8, not of 128
CASES = [(3, 9, 24, 40), (2, 130, 48, 16), (3, 300, 56, 72),
         (4, 130, 136, 24)]


def _inputs(dtype, e, m, k, n, seed):
    """A, B, dC rounded to ``dtype`` (so both packages see one value) and
    ``row_active`` with expert 0 all live and the last expert none."""
    rng = np.random.default_rng(seed)
    tiles = -(-m // 128)
    act = rng.integers(0, 2, (e, tiles)).astype(np.int32)
    act[0] = 1
    act[-1] = 0
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((e, m, k), (e, k, n), (e, m, n))]
    arrs[1] /= np.sqrt(k)
    ts = [torch.from_numpy(x).to(dtype) for x in arrs]
    return ts, torch.from_numpy(act)


def _jax_vjp(a, b, act, dc):
    """``jax.vjp`` of the reference's 2-D product, one expert at a time,
    in the operands' type (bfloat16 through ``ml_dtypes``)."""
    jdt = jnp.bfloat16 if a.dtype == BF else jnp.float32
    das, dbs = [], []
    for i in range(a.shape[0]):
        ai = jnp.asarray(a[i].float().numpy(), jdt)
        bi = jnp.asarray(b[i].float().numpy(), jdt)
        row = jnp.asarray(act[i].numpy())
        _, vjp = jax.vjp(lambda x, y: rref.wavefront_matmul_ref(x, y, row),
                         ai, bi)
        ga, gb = vjp(jnp.asarray(dc[i].float().numpy(), jnp.float32))
        das.append(np.asarray(ga.astype(jnp.float32)))
        dbs.append(np.asarray(gb.astype(jnp.float32)))
    return torch.from_numpy(np.stack(das)), torch.from_numpy(np.stack(dbs))


def _within(got, exp, tol):
    atol, rtol = tol
    err = (got.float() - exp.float()).abs()
    return bool((err <= atol + rtol * exp.float().abs()).all())


@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("e,m,k,n", CASES)
def test_matmul_bwd_cpu_equals_jax_vjp(dtype, e, m, k, n):
    """The CPU path (the plain version) against the reference's gradient;
    an inactive tile's dA and the idle expert's dB exactly zero."""
    (a, b, dc), act = _inputs(dtype, e, m, k, n, e * m + k + n)
    da, db = mops.matmul_bwd(a, b, act, dc)
    assert da.dtype == dtype and db.dtype == dtype
    assert da.shape == a.shape and db.shape == b.shape
    eda, edb = _jax_vjp(a, b, act, dc)
    tol = mops.TOLERANCE[dtype]
    assert _within(da, eda, tol)
    assert _within(db, edb, (tol[0] * m ** 0.5, tol[1]))
    assert torch.count_nonzero(da[~mref.tile_mask(act, m)]) == 0
    assert torch.count_nonzero(db[-1]) == 0


@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_matmul_bwd_autograd_equals_jax_vjp(dtype):
    """The operator's autograd (``wavefront_matmul`` then ``backward``)
    gives what ``jax.vjp`` gives, on the CPU."""
    (a, b, dc), act = _inputs(dtype, 3, 130, 48, 40, 7)
    ag, bg = a.clone().requires_grad_(), b.clone().requires_grad_()
    mops.wavefront_matmul(ag, bg, act).backward(dc)
    eda, edb = _jax_vjp(a, b, act, dc)
    tol = mops.TOLERANCE[dtype]
    assert _within(ag.grad, eda, tol)
    assert _within(bg.grad, edb, (tol[0] * 130 ** 0.5, tol[1]))


def _t(dtype, *shape, offset=0):
    """A zero tensor of ``shape`` whose data starts ``offset`` elements
    into its storage (``offset`` 1: its base off 16 bytes)."""
    flat = torch.zeros(int(np.prod(shape)) + offset, dtype=dtype)
    return flat[offset:].view(shape)


@pytest.mark.parametrize("dtype,e,m,k,n,want", [
    # bfloat16, TMA-legal A, B and dC: the in-place kernel, ragged M too
    (BF, 40, 818, 1536, 512, ("wgmma", "wgmma")),
    (BF, 40, 818, 512, 1536, ("wgmma", "wgmma")),
    (BF, 5, 9, 48, 64, ("wgmma", "wgmma")),
    (BF, 3, 300, 104, 64, ("wgmma", "wgmma")),
    (BF, 2, 1, 8, 8, ("wgmma", "wgmma")),
    # float32: the forward's rule on the copies, never wgmma
    (torch.float32, 5, 9, 48, 64, ("small_m", "simt")),
    (torch.float32, 3, 300, 160, 96, ("simt", "simt")),
    (torch.float32, 7, 200, 12, 24, ("simt", "small_m")),
    # bfloat16 with K or N off 16-byte rows: the copies, small_m or simt
    (BF, 3, 300, 100, 64, ("simt", "simt")),
    (BF, 3, 300, 96, 60, ("simt", "simt")),
    (BF, 3, 12, 96, 60, ("simt", "simt")),
    (BF, 3, 300, 12, 64, ("simt", "small_m"))])
def test_route_bwd_rule(dtype, e, m, k, n, want):
    a, b, dc = _t(dtype, e, m, k), _t(dtype, e, k, n), _t(dtype, e, m, n)
    assert mops.route_bwd(a, b, dc) == want


@pytest.mark.parametrize("which", ["a", "b", "dc"])
def test_route_bwd_misaligned_or_strided_bf16(which):
    """bfloat16 that TMA cannot read where it lies (a base off 16 bytes,
    or a transposed view) leaves the in-place kernel for the copies."""
    shapes = {"a": (2, 130, 64), "b": (2, 64, 48), "dc": (2, 130, 48)}
    ts = {w: _t(BF, *s) for w, s in shapes.items()}
    ts[which] = _t(BF, *shapes[which], offset=1)
    assert mops.route_bwd(ts["a"], ts["b"], ts["dc"]) == ("simt", "simt")
    ts[which] = _t(BF, *shapes[which][:-2], shapes[which][-1],
                   shapes[which][-2]).transpose(-1, -2)
    assert mops.route_bwd(ts["a"], ts["b"], ts["dc"])[0] != "wgmma"


def test_route_bwd_never_copies():
    """``"copies"`` (the first bfloat16 design) is named, never picked."""
    seen = set()
    for dtype in (torch.float32, BF):
        for m in (1, 9, 16, 17, 130):
            for k in (8, 12, 16, 100, 128):
                for n in (8, 12, 24, 60):
                    seen |= set(mops.route_bwd(
                        _t(dtype, 2, m, k), _t(dtype, 2, k, n),
                        _t(dtype, 2, m, n)))
    assert seen == {"wgmma", "small_m", "simt"}
    assert "copies" in mops.BWD_ROUTES


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("dtype,e,m,k,n,in_place", [
    (BF, 40, 818, 1536, 512, True), (BF, 5, 9, 48, 64, True),
    (BF, 3, 300, 100, 64, False), (torch.float32, 3, 300, 160, 96, False),
    (torch.float32, 40, 818, 1536, 512, False)])
def test_workspace_bytes(device, dtype, e, m, k, n, in_place):
    """The in-place route allocates nothing beyond its outputs; the
    copies' routes their copies and all-active flags; the product
    nothing."""
    a = torch.empty((e, m, k), dtype=dtype, device=device)
    b = torch.empty((e, k, n), dtype=dtype, device=device)
    el = a.element_size()
    mp = -(-m // mops.PAD_K) * mops.PAD_K
    copies = e * ((n * k + m * n + mp * n + k * mp) * el + -(-k // 128) * 4)
    assert mops.workspace_bytes(BWD, a, b) == (0 if in_place else copies)
    assert mops.workspace_bytes(FWD, a, b) == 0


def test_meta_fake_shapes_and_no_launch():
    """On ``meta`` the gradient takes its fake: dA and dB of A's and B's
    shapes and types, nothing launched, nothing counted."""
    before = (mops.wavefront_matmul.backward_launches,
              {p: dict(r) for p, r in
               mops.wavefront_matmul.backward_by_route.items()})
    for dtype in (torch.float32, BF):
        a = torch.empty((40, 818, 1536), dtype=dtype, device="meta")
        b = torch.empty((40, 1536, 512), dtype=dtype, device="meta")
        dc = torch.empty((40, 818, 512), dtype=dtype, device="meta")
        act = torch.ones((40, 7), dtype=torch.int32, device="meta")
        da, db = mops.matmul_bwd(a, b, act, dc)
        assert (da.shape, da.dtype, da.device.type) == (a.shape, dtype,
                                                        "meta")
        assert (db.shape, db.dtype, db.device.type) == (b.shape, dtype,
                                                        "meta")
    assert (mops.wavefront_matmul.backward_launches,
            mops.wavefront_matmul.backward_by_route) == before


@pytest.mark.parametrize("route", ["wgmma", "copies"])
def test_kernel_routes_refuse_cpu_tensors(route):
    """A named gradient route launches a kernel or raises: on CPU tensors
    there is none (the plain version is ``matmul_bwd``'s CPU path)."""
    (a, b, dc), act = _inputs(BF, 2, 9, 16, 8, 1)
    with pytest.raises(RuntimeError, match="no wavefront_matmul kernel"):
        mops.run_bwd_route(route, a, b, act, dc)


def test_run_bwd_route_unknown_name():
    (a, b, dc), act = _inputs(BF, 2, 9, 16, 8, 1)
    with pytest.raises(ValueError, match="unknown gradient route"):
        mops.run_bwd_route("simt", a, b, act, dc)


def test_counters_by_product_and_route():
    """Every gradient route has a counter for each product."""
    assert set(mops.wavefront_matmul.backward_by_route) == {"da", "db"}
    for r in mops.wavefront_matmul.backward_by_route.values():
        assert tuple(r) == mops.BWD_ROUTES
