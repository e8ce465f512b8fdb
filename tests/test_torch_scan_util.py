"""``repro_torch.models.scan_util.maybe_scan`` against the JAX reference's
``repro.models.scan_util.maybe_scan``, on the CPU, and its counting by
repetition under the dry run's ``StepTrace``.

* The same numpy-seeded carry and ``xs`` through one body written in
  each package: the carry and the stacked ``ys`` equal the reference's
  under both of its ``unroll_py`` values (``lax.scan`` and its Python
  loop), within float32's rounding of a product (rtol 1e-6, atol 1e-6)
  and exactly for integers; with ``xs=None`` and ``length``; and with a
  body that returns no ``ys``.
* Under ``StepTrace`` on ``meta`` tensors: once two consecutive steps
  count the same, the steps left are counted and not run, and every
  count (FLOPs, the live bytes' peak, collectives) equals a trace of
  every step, ``ys`` whose bytes grow each step included; a body whose
  steps never count the same, one that records a gradient and one on
  tensors with values run every step.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import scan_util as rscan  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import scan_util  # noqa: E402

RTOL = ATOL = 1e-6
STEPS, B, D = 7, 3, 5


def _inputs(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"h": f(B, D), "n": rng.integers(0, 9, (B,)).astype(np.int32),
            "w": f(D, D) * 0.5, "a": f(STEPS, B, D),
            "k": rng.integers(0, 5, (STEPS, B)).astype(np.int32)}


def _jax_body(w):
    def body(carry, x):
        h, n = carry
        h = jnp.tanh(h @ w + x["a"])
        n = n * 3 + x["k"]
        return (h, n), {"h": h, "s": h.sum(-1), "n": n}
    return body


def _torch_body(w):
    def body(carry, x):
        h, n = carry
        h = torch.tanh(h @ w + x["a"])
        n = n * 3 + x["k"]
        return (h, n), {"h": h, "s": h.sum(-1), "n": n}
    return body


def _close(got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("unroll_py", [False, True])
def test_carry_and_ys_equal_reference(unroll_py):
    v = _inputs()
    xs = {"a": v["a"], "k": v["k"]}
    (rh, rn), rys = rscan.maybe_scan(
        _jax_body(jnp.asarray(v["w"])), (jnp.asarray(v["h"]),
                                         jnp.asarray(v["n"])),
        jax.tree.map(jnp.asarray, xs), unroll_py=unroll_py)
    (th, tn), tys = scan_util.maybe_scan(
        _torch_body(torch.from_numpy(v["w"])),
        (torch.from_numpy(v["h"]), torch.from_numpy(v["n"])),
        {k: torch.from_numpy(a) for k, a in xs.items()})
    _close(th, rh)
    _close(tn, rn)
    assert set(tys) == set(rys)
    for k in rys:
        _close(tys[k], rys[k])


@pytest.mark.parametrize("unroll_py", [False, True])
def test_no_xs_with_length_equals_reference(unroll_py):
    v = _inputs(1)
    w = v["w"]

    def jbody(h, _):
        return jnp.tanh(h @ jnp.asarray(w)), h.max(-1)

    def tbody(h, _):
        return torch.tanh(h @ torch.from_numpy(w)), h.amax(-1)

    rh, rys = rscan.maybe_scan(jbody, jnp.asarray(v["h"]), None,
                               unroll_py=unroll_py, length=STEPS)
    th, tys = scan_util.maybe_scan(tbody, torch.from_numpy(v["h"]), None,
                                   length=STEPS)
    _close(th, rh)
    _close(tys, rys)


@pytest.mark.parametrize("unroll_py", [False, True])
def test_no_ys_equals_reference(unroll_py):
    v = _inputs(2)
    rc, rys = rscan.maybe_scan(lambda c, x: (c + x, None),
                               jnp.asarray(v["n"]), jnp.asarray(v["k"]),
                               unroll_py=unroll_py)
    tc, tys = scan_util.maybe_scan(lambda c, x: (c + x, None),
                                   torch.from_numpy(v["n"]),
                                   torch.from_numpy(v["k"]))
    assert rys is None and tys is None
    _close(tc, rc)


# ---------------------------------------------------------------------------
# counting by repetition
# ---------------------------------------------------------------------------

def _meta(*shape):
    return torch.empty(shape, device="meta")


def _traced(body, carry, xs, repeat, length=None):
    trace = dryrun.StepTrace(known=[carry, *(xs or {}).values()])
    runs = []

    def counted(c, x):
        runs.append(1)
        return body(c, x)

    with trace.mode(repeat=repeat):
        c, ys = scan_util.maybe_scan(counted, carry, xs, length=length)
    return trace, c, ys, len(runs)


def _counts(trace) -> tuple:
    return (trace.flops, trace.peak, trace.collectives(), trace.largest,
            sorted(trace.by_shape.items()))


@pytest.mark.parametrize("keep_ys", [False, True])
def test_repetition_equals_every_step(keep_ys):
    """A recurrence on ``meta`` tensors: the first step frees no carry
    (the first is an argument, not counted) and so is unlike the second;
    steps 2 and 3 agree, so steps 4 to 40 are counted as step 3 and not
    run.  With ``ys`` the live bytes grow by a step's entry each step,
    and the peak with them."""
    w = _meta(64, 64)
    xs = {"a": _meta(40, 16, 64)}

    def body(h, x):
        h = torch.tanh(h @ w + x["a"])
        return h, (h * 2 if keep_ys else None)

    first = _meta(16, 64)
    got = _traced(body, first, xs, True)
    want = _traced(body, first, xs, False)
    assert got[0].repeated == [(4, 37, 40)] and got[3] == 3
    assert want[0].repeated == [] and want[3] == 40
    assert _counts(got[0]) == _counts(want[0])
    assert got[0].flops == 40 * 2 * 16 * 64 * 64
    assert got[1].shape == want[1].shape == (16, 64)
    if keep_ys:
        assert got[2].shape == want[2].shape == (40, 16, 64)
        assert got[0].live == want[0].live
    else:
        assert got[2] is want[2] is None


def test_steps_that_never_agree_run_every_step():
    """A carry that grows a row a step: no two steps count the same, and
    the trace runs all of them."""
    w = _meta(64, 64)

    def body(h, _):
        h = torch.cat([h, h[:1]]) @ w
        return h, None

    got = _traced(body, _meta(4, 64), None, True, length=12)
    want = _traced(body, _meta(4, 64), None, False, length=12)
    assert got[0].repeated == [] and got[3] == want[3] == 12
    assert _counts(got[0]) == _counts(want[0])
    assert got[0].flops == sum(2 * (5 + i) * 64 * 64 for i in range(12))


def test_gradient_and_values_run_every_step():
    """A body that records a gradient (the backward needs each step's
    graph), and one on CPU tensors (their values are the result)."""
    w = _meta(8, 8).requires_grad_()

    def body(h, _):
        return h @ w, None

    trace, c, _, runs = _traced(body, _meta(2, 8), None, True, length=10)
    assert runs == 10 and trace.repeated == [] and c.requires_grad
    gen = torch.Generator().manual_seed(0)
    wv = torch.randn((8, 8), generator=gen) * 0.3
    h0 = torch.randn((2, 8), generator=gen)
    trace, c, ys, runs = _traced(lambda h, _: (h @ wv, h.sum()), h0, None,
                                 True, length=10)
    want, sums = h0, []
    for _ in range(10):
        sums.append(want.sum())
        want = want @ wv
    assert runs == 10 and trace.repeated == []
    assert torch.equal(c, want) and torch.equal(ys, torch.stack(sums))


@pytest.mark.parametrize("repeat", [False, True])
def test_counter_only_inside_a_trace(repeat):
    assert scan_util._counter is None
    trace = dryrun.StepTrace()
    with trace.mode(repeat=repeat):
        assert scan_util._counter is (trace if repeat else None)
    assert scan_util._counter is None
