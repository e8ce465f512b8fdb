"""The port's assembler, ISA tables and image packing against the
reference's: the packed ``(L, 7)`` int32 images — the seam between the
two packages — are ``np.array_equal`` for the suite x CONFIGS of
``test_blockc.py``, and so are the encoded words, the NOP-scheduled
listings and the per-opcode metadata table (tolerance: none).
"""
import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import _torch_port as tp  # noqa: E402
from repro import programs as rprog  # noqa: E402
from repro.core import EGPUConfig as RCfg  # noqa: E402
from repro.core import cost as rcost, isa as risa  # noqa: E402
from repro.core.executor import pad_image as ref_pad  # noqa: E402
from repro.core.executor import tables_np as ref_tables  # noqa: E402
from repro_torch import programs as tprog  # noqa: E402
from repro_torch.core import EGPUConfig  # noqa: E402
from repro_torch.core import cost as tcost, isa as tisa  # noqa: E402
from repro_torch.core.executor import pad_image, tables_np  # noqa: E402
from repro_torch.programs import suite as psuite  # noqa: E402


@pytest.mark.parametrize("name", sorted(tp.CONFIGS))
def test_packed_images_equal(name):
    rb = tp.suite(rprog, tp.config(RCfg, name))
    pb = tp.suite(tprog, tp.config(EGPUConfig, name))
    assert sorted(rb) == sorted(pb)
    for i in rb:
        r, p = rb[i], pb[i]
        assert r.name == p.name
        assert np.array_equal(ref_pad(r.image)[0], pad_image(p.image)[0])
        assert np.array_equal(r.image.words, p.image.words)
        assert r.image.listing == p.image.listing
        assert r.image.threads_active == p.image.threads_active
        assert np.array_equal(np.asarray(r.shared_init),
                              np.asarray(p.shared_init))


@pytest.mark.parametrize("name", sorted(tp.CONFIGS))
def test_opcode_table_equal(name):
    assert np.array_equal(ref_tables(tp.config(RCfg, name)),
                          tables_np(tp.config(EGPUConfig, name)))


def test_paper_suite_images_equal():
    """The chip-smoke suite at paper size assembles identically too."""
    from repro.core import benchmark_config as rbc
    from repro_torch.core import benchmark_config as tbc
    for r, p in zip(psuite.build_suite(rprog, rbc),
                    psuite.build_suite(tprog, tbc)):
        assert r.name == p.name
        assert np.array_equal(ref_pad(r.image)[0], pad_image(p.image)[0])


def test_isa_and_cost_constants_equal():
    assert [(o.name, int(o)) for o in risa.Op] == \
        [(o.name, int(o)) for o in tisa.Op]
    assert risa.OP_CLASS == tisa.OP_CLASS
    for s in ("SCALAR_OPS", "REG_WRITE_OPS", "READS_RA", "READS_RB",
              "READS_RD", "PRED_WRITE_OPS", "IF_OPS"):
        assert {int(o) for o in getattr(risa, s)} == \
            {int(o) for o in getattr(tisa, s)}, s
    cfg_r, cfg_t = tp.config(RCfg, "qp"), tp.config(EGPUConfig, "qp")
    for op in range(risa.NUM_OPCODES):
        for tsc in range(16):
            if tsc >> 2 == 3:
                continue
            assert rcost.issue_cycles(op, tsc, 2, cfg_r) == \
                tcost.issue_cycles(op, tsc, 2, cfg_t)
