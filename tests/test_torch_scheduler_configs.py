"""The port's ``Fleet`` against the JAX package's on the other two
CONFIGS (``alu16``, ``nopred``), and ``drain_isolated`` under a seeded
``FaultPlan``: the rest of ``test_torch_scheduler.py``'s differential
drains (same submissions, bit-identical ``JobResult``s, equal
``FleetStats`` counts; tolerance: none), split off so that each file
stays near a minute on the CPU.
"""
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_port as tp  # noqa: E402
import test_torch_scheduler as ts  # noqa: E402
from repro import fleet as rfleet  # noqa: E402
from repro.core import EGPUConfig as RCfg  # noqa: E402
from repro_torch.core import EGPUConfig  # noqa: E402
from repro_torch.fleet import FaultPlan, FleetScheduler  # noqa: E402


@pytest.mark.parametrize("name", sorted(set(tp.CONFIGS)
                                        - set(ts.DRAIN_CONFIGS)))
def test_drain_matches_reference(name):
    ts.check_drain(name)


def test_isolated_drain_under_faults_matches_reference():
    """``drain_isolated`` under one seeded plan (a compile fault and a
    dispatch fault): both packages degrade and bisect the same units,
    and every result still equals the reference's."""
    jobs = ts._jobs("dp")
    rs = rfleet.FleetScheduler(tp.config(RCfg, "dp"), batch_size=4)
    ps = FleetScheduler(tp.config(EGPUConfig, "dp"), batch_size=4,
                        device="cpu")
    out = []
    for sched, pkg, side in ((rs, rfleet, 0), (ps, None, 1)):
        plan = (pkg.FaultPlan if pkg else FaultPlan)(
            seed=3, compile={"count": 1}, dispatch={"count": 1})
        ts._submit(sched, [j[side] for j in jobs])
        with plan:
            out.append(sched.drain_isolated())
        assert plan.injected == {"compile": 1, "dispatch": 1}
    (rres, rfail), (pres, pfail) = out
    assert rfail == pfail == {}
    for h in pres:
        ts.assert_results_equal(rres[h], pres[h], f"faults/{h}")
    ts.assert_stats_equal(rs.stats, ps.stats, "faults")
    assert ps.stats.degraded_units >= 1 and ps.stats.bisections >= 1


