"""The roofline arithmetic on known shapes."""
import pytest

from portbench import programs, roofline, spec


def test_step_work_by_hand():
    # 1,024 cores, every one of 512 threads active: Ra, Rb, Rd a thread,
    # a mask byte a thread and a 56-byte row a core
    assert roofline.fp_step_work(1024, 512, 512) == (
        1024 * 512, 1024 * (12 * 512 + 512 + 56))
    assert roofline.ext_step_work(2, 16, 512) == (
        2 * 32, 2 * (8 * 16 + 512 + 56 + 4))
    ops, nbytes = roofline.fp_step_work(1024, 512, 512)
    assert roofline.min_seconds(ops, nbytes) == nbytes / 3.35e12


def test_share():
    assert roofline.share(1.0, 10, (4.0, 10)) == 25.0
    # launches the profiler dropped scale the least time down
    assert roofline.share(1.0, 10, (2.0, 5)) == 25.0
    assert roofline.share(1.0, 10, (0.0, 0)) is None


@pytest.mark.parametrize("prog,fp,dot", [
    ("reduction_32_dp", 5, 0), ("transpose_32_dp", 0, 0),
    ("matmul_32_dp", 2 * 32 * 2, 0), ("reduction_dot_32_dp", 0, 1),
    ("matmul_dot_32_dp", 0, 32 * 32)])
def test_path_launches(prog, fp, dot):
    name = "egpu-dot" if "dot" in prog else "egpu-dp"
    doc = spec.cell(spec.load(), f"{name}.sweep").config
    core, (p,) = programs.load(doc, [prog])
    work = roofline.path_work(core, p.path, p.threads, 1024)
    assert work["wavefront_alu"][0] == fp
    assert work["dot_product"][0] == dot
    for launches, least in work.values():
        assert (least > 0) == (launches > 0)
