"""The port's verified pre-compile optimizer
(``repro_torch.analysis.optimizer``) against the JAX package's, on the
CPU: the port of ``test_optimizer.py``.

``optimize_image`` must emit the reference's optimized image word for
word (and the same transform counts) on the lint suite and on generated
programs across the four CONFIGS.  ``compile_program(optimize=True)``
in every port tier (blocks, superblock, auto) must give every
``MachineState`` leaf of the reference's
``compile_program(optimize=True).run`` (tolerance: none), and its
architectural end state (registers, shared memory, halt flag) must
equal the unoptimized image's, the optimizer's guarantee.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_port as tp  # noqa: E402
from repro.analysis import lint as ref_lint  # noqa: E402
from repro.analysis.optimizer import optimize_image as ref_optimize  # noqa: E402
from repro.core import EGPUConfig as RCfg  # noqa: E402
from repro.core import compile_program as ref_compile  # noqa: E402
from repro.programs.generator import generate_program as ref_gen  # noqa: E402
from repro_torch.analysis import lint  # noqa: E402
from repro_torch.analysis.concrete import concrete_run  # noqa: E402
from repro_torch.analysis.optimizer import (OptResult,  # noqa: E402
                                            optimize_image,
                                            optimize_image_cached)
from repro_torch.core import (Asm, EGPUConfig, compile_program,  # noqa: E402
                              run_compiled, run_program)
from repro_torch.core.blockc import program_key  # noqa: E402
from repro_torch.core.machine import state_to_numpy  # noqa: E402
from repro_torch.programs.generator import generate_program  # noqa: E402

CFG = tp.config(EGPUConfig, "dp")
RCFG = tp.config(RCfg, "dp")
SUITE = lint.suite(CFG)
REF_SUITE = ref_lint.suite(RCFG)
IDS = [b.name for b in SUITE]

_FIELDS = ("changed", "rounds", "folds", "dce_removed", "nops_before",
           "nops_after", "reason", "instrs_before", "instrs_after")


def assert_same_optimization(ref, got, label):
    assert isinstance(got, OptResult)
    for f in _FIELDS:
        assert getattr(got, f) == getattr(ref, f), f"{label}: {f}"
    assert got.image.threads_active == ref.image.threads_active, label
    assert np.array_equal(got.image.words, ref.image.words), label


def _arch(leaves: dict):
    return leaves["regs"], leaves["shared"], bool(leaves["halted"])


@pytest.mark.parametrize("k", range(len(SUITE)), ids=IDS)
def test_suite_optimized_word_for_word(k):
    b, rb = SUITE[k], REF_SUITE[k]
    got = optimize_image(b.image, b.image.threads_active, tdx_dim=b.tdx_dim)
    assert not got.reason or not got.changed, got.reason
    assert_same_optimization(
        ref_optimize(rb.image, rb.image.threads_active, tdx_dim=rb.tdx_dim),
        got, b.name)


@pytest.mark.parametrize("k", range(len(SUITE)), ids=IDS)
def test_compile_optimize_leaf_identical_in_every_tier(k):
    """Every port tier of ``compile_program(optimize=True)`` equals the
    reference's optimized compiled run leaf for leaf, and its
    architectural end state equals the unoptimized image's."""
    b, rb = SUITE[k], REF_SUITE[k]
    ref = tp.reference_leaves(
        ref_compile(rb.image, optimize=True).run(
            shared_init=rb.shared_init, tdx_dim=rb.tdx_dim))
    plain = state_to_numpy(run_program(b.image, shared_init=b.shared_init,
                                       tdx_dim=b.tdx_dim, device="cpu"))
    for mode in ("blocks", "superblock", "auto"):
        cp = compile_program(b.image, mode=mode, optimize=True)
        got = state_to_numpy(cp.run(shared_init=b.shared_init,
                                    tdx_dim=b.tdx_dim, device="cpu"))
        tp.assert_leaves_equal(ref, got, f"{b.name}/{mode}")
        for r, g in zip(_arch(plain), _arch(got)):
            assert np.array_equal(r, g), f"{b.name}/{mode}"


@pytest.mark.parametrize("k", range(len(SUITE)), ids=IDS)
def test_optimized_schedule_is_hazard_free(k):
    b = SUITE[k]
    res = optimize_image(b.image, b.image.threads_active, tdx_dim=b.tdx_dim)
    st_ = run_program(res.image, threads=res.image.threads_active,
                      tdx_dim=b.tdx_dim, shared_init=b.shared_init,
                      device="cpu")
    assert int(st_.hazard_violations) == 0


def test_fft_actually_optimizes_and_reduction_round_trips():
    fft = next(b for b in SUITE if b.name.startswith("fft_16"))
    res = optimize_image(fft.image, fft.image.threads_active,
                         tdx_dim=fft.tdx_dim)
    assert res.changed and res.folds >= 1 and res.dce_removed >= 1
    assert res.image.n < fft.image.n
    red = next(b for b in SUITE if b.name == "reduction_32_dp")
    res = optimize_image(red.image, red.image.threads_active,
                         tdx_dim=red.tdx_dim)
    assert not res.changed
    assert res.image.words.tobytes() == red.image.words.tobytes()


def test_input_errors_bail_and_cache_hits():
    a = Asm(CFG)
    a.lodi(1, CFG.shared_words + 5)
    a.sto(1, 1)
    img = a.assemble(threads_active=32)
    res = optimize_image(img, 32)
    assert not res.changed
    assert res.reason == "input-has-errors"
    assert res.image is img
    b = SUITE[0]
    r1 = optimize_image_cached(b.image, b.image.threads_active,
                               tdx_dim=b.tdx_dim)
    assert optimize_image_cached(b.image, b.image.threads_active,
                                 tdx_dim=b.tdx_dim) is r1


def test_compile_program_optimize_keys_the_optimized_image():
    fft = next(b for b in SUITE if b.name.startswith("fft_16"))
    cp = compile_program(fft.image, optimize=True)
    want = optimize_image(fft.image, fft.image.threads_active).image
    assert program_key(cp.image) == program_key(want)
    assert compile_program(fft.image, optimize=True) is cp
    assert compile_program(fft.image) is not cp


GEN = [(name, seed) for name in sorted(tp.CONFIGS)
       for seed in (0, 2, 3, 5, 11, 19, 23, 31)]


@pytest.mark.parametrize("name,seed", GEN, ids=[f"{n}-{s}" for n, s in GEN])
def test_generated_programs_optimize_as_the_reference(name, seed):
    """Generated programs: the same optimized words as the reference,
    the built-in differential verification holds, and the numpy
    executor agrees between the original and optimized images, as does
    the port's superblock tier where the compiler takes the program."""
    img = generate_program(tp.config(EGPUConfig, name), seed)
    rimg = ref_gen(tp.config(RCfg, name), seed)
    res = optimize_image(img, img.threads_active)
    assert_same_optimization(ref_optimize(rimg, rimg.threads_active), res,
                             f"{name}/{seed}")
    a = concrete_run(img, img.threads_active)
    b = concrete_run(res.image, res.image.threads_active)
    assert a.halted == b.halted
    assert np.array_equal(a.regs, b.regs)
    assert np.array_equal(a.shared, b.shared)
    plain = state_to_numpy(run_compiled(img, device="cpu"))
    opt = state_to_numpy(run_compiled(res.image, device="cpu"))
    for r, g in zip(_arch(plain), _arch(opt)):
        assert np.array_equal(r, g), f"{name}/{seed}"
