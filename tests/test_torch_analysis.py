"""The port's static analyzer (``repro_torch.analysis``) against the JAX
package's, on the CPU: the ports of ``test_analysis.py`` and
``test_analysis_soundness.py``.

The same program, assembled by each package, must get the same
diagnostics (severity, code, pc, message, path) and the same facts from
``analyze``, and the same ``ConcreteResult`` from the numpy
``concrete_run`` (tolerance: none) — on the lint suite
(``analysis/lint.py``'s ``suite``), on targeted broken constructs, and
on generator samples across the four CONFIGS, hostile ones included.
The port's own soundness sweep, admission lint (``check_job``) and lint
CLI are checked as the reference's tests check the reference's.
"""
import contextlib
import io

import numpy as np
import pytest
from _hyp import given, settings, st

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_port as tp  # noqa: E402
from repro.analysis import analyze as ref_analyze  # noqa: E402
from repro.analysis import lint as ref_lint  # noqa: E402
from repro.analysis.concrete import concrete_run as ref_concrete  # noqa: E402
from repro.core import Asm as RAsm, EGPUConfig as RCfg, Op as ROp  # noqa: E402
from repro.programs.generator import generate_program as ref_gen  # noqa: E402
from repro_torch.analysis import (AnalysisReport,  # noqa: E402
                                  ProgramVerificationError, analyze,
                                  analyze_cached)
from repro_torch.analysis import lint  # noqa: E402
from repro_torch.analysis.concrete import concrete_run  # noqa: E402
from repro_torch.core import Asm, EGPUConfig, Op, run_program  # noqa: E402
from repro_torch.core.isa import decode_word, encode_word  # noqa: E402
from repro_torch.fleet.scheduler import check_job  # noqa: E402
from repro_torch.programs.generator import generate_program  # noqa: E402

CFG = tp.config(EGPUConfig, "dp")
RCFG = tp.config(RCfg, "dp")
SUITE = lint.suite(CFG)
REF_SUITE = ref_lint.suite(RCFG)


def _diags(rep) -> list:
    return [(int(d.severity), d.code, d.pc, d.message, tuple(d.path))
            for d in rep.diagnostics]


def assert_reports_equal(ref, got, label):
    assert _diags(got) == _diags(ref), label
    assert got.facts == ref.facts, label
    assert got.ok == ref.ok and got.counts() == ref.counts(), label


def assert_concrete_equal(ref, got, label):
    for f in ("halted", "steps", "observed_addr", "oob_pcs",
              "max_pred_depth", "max_loop_depth", "max_call_depth",
              "stack_faults", "executed_pcs"):
        assert getattr(got, f) == getattr(ref, f), f"{label}: {f}"
    for f in ("regs", "shared"):
        r, g = getattr(ref, f), getattr(got, f)
        assert r.dtype == g.dtype and np.array_equal(r, g), f"{label}: {f}"


# --------------------------------------------------------------------------
# the lint suite: clean, exact facts, the reference's reports
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", range(len(SUITE)),
                         ids=[b.name for b in SUITE])
def test_suite_lints_clean_as_the_reference(k):
    b, rb = SUITE[k], REF_SUITE[k]
    rep = analyze(b.image, b.image.threads_active, tdx_dim=b.tdx_dim)
    assert rep.errors() == [], rep.render()
    assert rep.warnings() == [], rep.render()
    assert_reports_equal(ref_analyze(rb.image, rb.image.threads_active,
                                     tdx_dim=rb.tdx_dim), rep, b.name)


@pytest.mark.parametrize("k", range(len(SUITE)),
                         ids=[b.name for b in SUITE])
def test_static_steps_match_the_ports_interpreter(k):
    b = SUITE[k]
    rep = analyze(b.image, b.image.threads_active, tdx_dim=b.tdx_dim)
    st_ = run_program(b.image, threads=b.image.threads_active,
                      tdx_dim=b.tdx_dim, shared_init=b.shared_init,
                      device="cpu")
    assert rep.facts["static_steps"] == int(st_.steps)


def test_facts_shape_and_cache():
    b = SUITE[0]
    rep = analyze(b.image, b.image.threads_active, tdx_dim=b.tdx_dim)
    for key in ("threads", "tdx_dim", "n_blocks", "reached_blocks",
                "static_steps", "loop_trips", "access_verdicts",
                "max_pred_depth", "max_loop_depth", "max_call_depth",
                "fold_candidates", "pred_at", "analysis_clipped"):
        assert key in rep.facts, key
    assert rep.facts["pred_at"].get(0) == 0
    r1 = analyze_cached(b.image, b.image.threads_active, tdx_dim=b.tdx_dim)
    assert analyze_cached(b.image, b.image.threads_active,
                          tdx_dim=b.tdx_dim) is r1
    assert isinstance(r1, AnalysisReport)


# --------------------------------------------------------------------------
# targeted constructs: one finding each, as the reference finds it
# --------------------------------------------------------------------------

def _stray_endif(a, O, c):
    a.lodi(1, 7)
    a.endif()


def _stray_else(a, O, c):
    a.else_()


def _pred_overflow(a, O, c):
    a.lodi(1, 1)
    for _ in range(c.predicate_levels + 1):
        a.if_("nz", 1)
    for _ in range(c.predicate_levels + 1):
        a.endif()


def _loop_overflow(a, O, c):
    for _ in range(c.max_loop_depth + 1):
        a.init(0)


def _loop_underflow(a, O, c):
    top = a.label()
    a.lodi(1, 1)
    a.loop_(top)


def _rts_underflow(a, O, c):
    a.rts()


def _bad_branch(a, O, c):
    a.emit(O.JMP, imm=4096)


def _oob_store(a, O, c):
    a.lodi(1, c.shared_words + 5)
    a.lodi(2, 1)
    a.sto(2, 1)


def _undefined_read(a, O, c):
    a.add(1, 2, 3)


def _both_arms(a, O, c):
    a.tdx(1)
    a.if_("nz", 1)
    a.lodi(2, 10)
    a.else_()
    a.lodi(2, 20)
    a.endif()
    a.add(3, 2, 2)


def _one_arm(a, O, c):
    a.tdx(1)
    a.if_("nz", 1)
    a.lodi(2, 10)
    a.endif()
    a.add(3, 2, 2)


def _inside_arm(a, O, c):
    a.tdx(1)
    a.if_("nz", 1)
    a.lodi(2, 10)
    a.add(3, 2, 2)
    a.endif()


#: (assembling function, the code it must raise, its severity:
#: "error"/"warn", or None for a clean report)
CONSTRUCTS = {
    "stray_endif": (_stray_endif, "pred-underflow", "error"),
    "stray_else": (_stray_else, "pred-underflow", "error"),
    "pred_overflow": (_pred_overflow, "pred-overflow", "error"),
    "loop_overflow": (_loop_overflow, "loop-overflow", "error"),
    "loop_underflow": (_loop_underflow, "loop-underflow", "error"),
    "rts_underflow": (_rts_underflow, "call-underflow", "error"),
    "bad_branch": (_bad_branch, "bad-branch-target", "error"),
    "oob_store": (_oob_store, "oob-access", "error"),
    "undefined_read": (_undefined_read, "undefined-read", "warn"),
    "both_arms": (_both_arms, None, None),
    "one_arm": (_one_arm, "partial-def-read", "warn"),
    "inside_arm": (_inside_arm, None, None),
}


def _build_both(build):
    pa, ra = Asm(CFG), RAsm(RCFG)
    build(pa, Op, CFG)
    build(ra, ROp, RCFG)
    return (pa.assemble(threads_active=32), ra.assemble(threads_active=32))


@pytest.mark.parametrize("name", sorted(CONSTRUCTS))
def test_construct_diagnosed_as_the_reference(name):
    build, code, sev = CONSTRUCTS[name]
    img, rimg = _build_both(build)
    rep = analyze(img, 32)
    assert_reports_equal(ref_analyze(rimg, 32), rep, name)
    if sev == "error":
        assert code in {d.code for d in rep.errors()}, rep.render()
    elif sev == "warn":
        assert code in {d.code for d in rep.warnings()}, rep.render()
        assert rep.errors() == []
    else:
        assert rep.warnings() == [] and rep.errors() == [], rep.render()


def test_undefined_tsc_width_is_error():
    def forge(a, O, c):
        a.lodi(1, 7)

    img, rimg = _build_both(forge)
    for im in (img, rimg):      # emit() refuses width '11': forge the word
        ins = decode_word(int(im.words[0]), CFG.regs_per_thread)
        im.words[0] = np.uint64(encode_word(ins._replace(tsc=0b1100),
                                            CFG.regs_per_thread))
        im.tsc[0] = 0b1100
    rep = analyze(img, 32)
    assert "undefined-tsc-width" in {d.code for d in rep.errors()}
    assert_reports_equal(ref_analyze(rimg, 32), rep, "tsc")


def test_fixpoint_path_fault_not_erased_at_join():
    """Generator seed 1002 (hostile): the stack fault seen during the
    fixpoint survives the join with the clean entry state."""
    img = generate_program(CFG, 1002, hostility=1.0)
    res = concrete_run(img, img.threads_active)
    assert "loop-overflow" in res.stack_faults
    assert "loop-overflow" in {
        d.code for d in analyze(img, img.threads_active).errors()}


# --------------------------------------------------------------------------
# generated programs: reports and concrete runs equal the reference's
# --------------------------------------------------------------------------

GEN_CASES = [(name, h) for name in sorted(tp.CONFIGS) for h in (0.0, 1.0)]


@pytest.mark.parametrize("name,hostility", GEN_CASES,
                         ids=[f"{n}-{h}" for n, h in GEN_CASES])
def test_generated_programs_analyzed_as_the_reference(name, hostility):
    cfg, rcfg = tp.config(EGPUConfig, name), tp.config(RCfg, name)
    seeds = range(40) if hostility == 0.0 else range(1000, 1040)
    for seed in seeds:
        img = generate_program(cfg, seed, hostility=hostility)
        rimg = ref_gen(rcfg, seed, hostility=hostility)
        label = f"{name}/{seed}"
        assert_reports_equal(ref_analyze(rimg, rimg.threads_active),
                             analyze(img, img.threads_active), label)
        shared = np.random.default_rng(seed).integers(
            0, 2**32, 48, dtype=np.uint64).astype(np.uint32)
        assert_concrete_equal(
            ref_concrete(rimg, rimg.threads_active, tdx_dim=8,
                         shared_init=shared),
            concrete_run(img, img.threads_active, tdx_dim=8,
                         shared_init=shared), label)


# --------------------------------------------------------------------------
# soundness: the port's verifier never calls a faulting program safe
# --------------------------------------------------------------------------

def _assert_sound(img) -> str:
    rep = analyze(img, img.threads_active)
    if rep.errors():
        return "rejected"
    res = concrete_run(img, img.threads_active)
    facts = rep.facts
    assert res.halted, "verified program did not halt"
    assert not res.stack_faults, res.stack_faults
    proved = {pc for pc, v in facts["access_verdicts"].items()
              if v == "proved"}
    assert not proved & set(res.oob_pcs)
    if facts["static_steps"] is not None:
        assert facts["static_steps"] == res.steps
    if not facts["analysis_clipped"]:
        assert facts["max_pred_depth"] >= res.max_pred_depth
        assert facts["max_loop_depth"] >= res.max_loop_depth
        assert facts["max_call_depth"] >= res.max_call_depth
    return "verified"


@pytest.mark.parametrize("hostility,seeds,floor", [
    (0.0, range(0, 300), 150), (1.0, range(1000, 1260), 65)],
    ids=["clean", "hostile"])
def test_soundness_sweep(hostility, seeds, floor):
    """Clean programs are mostly verified, hostile ones often rejected,
    and every verified one behaves as the analyzer predicts."""
    want = "verified" if hostility == 0.0 else "rejected"
    hits = sum(_assert_sound(generate_program(CFG, s, hostility=hostility))
               == want for s in seeds)
    assert hits >= floor


def test_hostile_mode_catches_known_fault_kinds():
    codes: set = set()
    for seed in range(1000, 1260):
        img = generate_program(CFG, seed, hostility=1.0)
        codes |= {d.code for d in analyze(img, img.threads_active).errors()}
        if {"pred-underflow", "bad-branch-target",
                "loop-overflow"} <= codes:
            break
    assert {"pred-underflow", "bad-branch-target", "loop-overflow"} <= codes


@given(st.integers(min_value=0, max_value=2 ** 31 - 1), st.booleans())
@settings(max_examples=30, deadline=None)
def test_soundness_property(seed, hostile):
    _assert_sound(generate_program(CFG, seed,
                                   hostility=1.0 if hostile else 0.0))


@pytest.mark.parametrize("seed", [0, 3, 5, 7, 9, 13, 17, 21])
def test_concrete_reference_matches_the_ports_interpreter(seed):
    """The numpy executor equals the port's interpreter on generated
    programs the analyzer admits (bit-identical registers and shared
    memory, zero hazard violations)."""
    img = generate_program(CFG, seed)
    if analyze(img, img.threads_active).errors():
        pytest.skip("analyzer rejects this seed (conservative)")
    res = concrete_run(img, img.threads_active)
    st_ = run_program(img, threads=img.threads_active, device="cpu")
    assert bool(st_.halted) == res.halted
    assert int(st_.steps) == res.steps
    assert np.array_equal(res.regs.view(np.int32), st_.regs.numpy())
    assert np.array_equal(res.shared.view(np.int32), st_.shared.numpy())
    assert int(st_.hazard_violations) == 0


# --------------------------------------------------------------------------
# submit-time admission and the lint CLI
# --------------------------------------------------------------------------

def _bad_image():
    img, _ = _build_both(_oob_store)
    return img


def test_check_job_rejects_error_programs():
    with pytest.raises(ProgramVerificationError) as ei:
        check_job(CFG, _bad_image(), None, 32)
    assert any(d.code == "oob-access" for d in ei.value.diagnostics)
    assert isinstance(ei.value, ValueError)
    img, _ = _build_both(_bad_branch)
    with pytest.raises(ProgramVerificationError) as ei:
        check_job(CFG, img, None, 32)
    assert any(d.code == "bad-branch-target" for d in ei.value.diagnostics)
    check_job(CFG, _bad_image(), None, 32, lint=False)   # opt-out
    for b in SUITE:
        check_job(CFG, b.image, b.shared_init, b.image.threads_active,
                  tdx_dim=b.tdx_dim)


@pytest.mark.parametrize("argv", [["--json"], ["--json", "--optimize"],
                                  ["--bench", "fft", "--min-severity",
                                   "warn"]],
                         ids=["json", "optimize", "fft-warn"])
def test_lint_cli_prints_what_the_reference_prints(argv):
    outs = []
    for main in (ref_lint.main, lint.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(list(argv))
        outs.append((rc, buf.getvalue()))
    assert outs[1] == outs[0]
    assert outs[1][0] == 0
