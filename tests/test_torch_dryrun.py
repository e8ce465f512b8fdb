"""The port's dry-run tools (``repro_torch.launch.specs``, ``.dryrun``)
against the JAX reference's, on the CPU.

* ``collective_bytes`` equals the reference's on the same HLO text,
  ``-start``/``-done`` pairs included;
* for every architecture's smoke config, each kind of cell (train,
  prefill, decode) on a (2, 2) mesh: the parameter count equals the
  reference's ``specs.param_count`` of ``jax.eval_shape``; the step runs
  on the ``meta`` arguments; ``argument_bytes`` equals the sum of rank
  0's shards as ``DTensor`` cuts them itself (``distribute_tensor`` on a
  placeholder group, in a subprocess); the ``meta`` FLOP count equals
  ``FlopCounterMode``'s count of the same step on CPU tensors;
* every architecture's parameter count at full width equals the
  reference's (``jax.eval_shape`` against ``convert._layout``: nothing is
  allocated);
* the CLI writes a record a mesh with the reference's keys and the
  ``torch`` that counted it: collective bytes and counts by the
  reference's five kinds, temporary bytes, one device's FLOPs (together
  at least the whole step's, as ``measure`` counts it unpartitioned on
  the ``FakeMesh``) and argument bytes those of ``build_cell`` in this
  process; for granite's ``decode_32k`` and xlstm's ``prefill_32k``
  (32,768 decode steps, counted by repetition);
* a scan's steps counted by repetition give the record that tracing
  every step gives, field for field but ``lower_s``: xlstm's smoke
  prefill on a (2, 2) mesh, and xlstm-350m's prefill at published
  widths on 16x16, its prompt cut to 24 tokens;
* the LM kernels' operators take their fake implementations on a
  ``meta`` tensor, forward and backward, the eGPU kernels their plain
  versions, and no launch is counted.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import repro.configs as C  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.launch import specs as rspecs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.transformer import Model, tree_map  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _reference_dryrun():
    """The reference's ``launch.dryrun`` module; its import sets
    ``XLA_FLAGS`` for 512 host devices, which is put back at once so that
    no later JAX initialisation in this process sees it."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as rdryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return rdryrun


HLO = {
    "all-reduce": "  %all-reduce.1 = f32[1024,512]{1,0} all-reduce(f32[1024,"
                  "512]{1,0} %p0), replica_groups={{0,1}}, to_apply=%add",
    "start-done": "  %ag = (f32[256]{0}, f32[1024]{0}) all-gather-start("
                  "f32[256]{0} %x), dimensions={0}\n"
                  "  %agd = f32[1024]{0} all-gather-done((f32[256]{0}, "
                  "f32[1024]{0}) %ag)",
    "mixed": "ENTRY %main {\n"
             "  %rs = bf16[64,128]{1,0} reduce-scatter(bf16[1024,128]{1,0}"
             " %y), dimensions={0}\n"
             "  %a2a = (s32[8,4]{1,0}, s32[8,4]{1,0}) all-to-all(s32[8,4]"
             "{1,0} %a, s32[8,4]{1,0} %b)\n"
             "  %cp = u8[16]{0} collective-permute(u8[16]{0} %z)\n"
             "  %cps = (pred[3]{0}, pred[3]{0}) collective-permute-start("
             "pred[3]{0} %w)\n"
             "  %cpd = pred[3]{0} collective-permute-done((pred[3]{0}, "
             "pred[3]{0}) %cps)\n"
             "  %sum = f32[4]{0} add(f32[4]{0} %q, f32[4]{0} %r)\n"
             "  %ar = c64[2,2]{1,0} all-reduce(c64[2,2]{1,0} %c)\n}",
    "none": "  %dot = f32[8,8]{1,0} dot(f32[8,8]{1,0} %a, f32[8,8]{1,0} %b)",
}


@pytest.mark.parametrize("name", sorted(HLO))
def test_collective_bytes_equals_reference(name):
    want = _reference_dryrun().collective_bytes(HLO[name])
    got = dryrun.collective_bytes(HLO[name])
    assert got == want
    if name == "start-done":
        assert got["count"]["all-gather"] == 1


class FakeMesh:
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


MESH = FakeMesh((2, 2), ("data", "model"))
KINDS = ("train", "prefill", "decode")


def _shape(cfg, kind):
    """A small shape of ``kind``: 4 sequences of 32 tokens (internvl2's
    patches before them), a decode cache of 64."""
    if kind == "decode":
        return tconfigs.ShapeSpec("decode_small", 64, 4, kind)
    s = 32 + (cfg.num_patches if cfg.family == "vlm" else 0)
    return tconfigs.ShapeSpec(f"{kind}_small", s, 4, kind)


def _cell(arch, kind, mesh=MESH):
    cfg = tconfigs.get_smoke(arch)
    return specs.build_cell(arch, None, mesh, cfg=cfg, shape=_shape(cfg, kind),
                            enc_len=16)


def _reference_count(cfg):
    return rspecs.param_count(jax.eval_shape(
        lambda: rapi.init_params(jax.random.PRNGKey(0), cfg)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_cell_on_meta_against_reference(arch, kind):
    cell = _cell(arch, kind)
    assert cell.model_params_bytes == _reference_count(C.get_smoke(arch))
    assert cell.shape.kind == kind
    assert all(t.device.type == "meta"
               for t, _ in specs.placed_leaves(cell.args, cell.in_shardings))
    m = dryrun.measure(cell)
    assert m["memory"]["argument_bytes"] == specs.argument_bytes(cell) > 0
    assert m["memory"]["output_bytes"] > 0 and m["cost"]["flops"] > 0
    assert cell.donate_argnums == {"train": (0, 1), "prefill": (),
                                   "decode": (1,)}[kind]


def _real(cfg, x, gen):
    """A CPU tensor like meta tensor ``x``: token ids below the vocabulary,
    zero lengths, all slots active, small floats."""
    if x.dtype.is_floating_point:
        return (torch.randn(x.shape, generator=gen) * 0.05).to(x.dtype)
    return torch.randint(0, cfg.vocab, x.shape, generator=gen,
                         dtype=x.dtype)


def _cpu_args(cell):
    gen = torch.Generator().manual_seed(0)
    real = lambda x: None if x is None else _real(cell.cfg, x, gen)
    out = []
    for a in cell.args:
        if isinstance(a, Model):
            out.append(convert.as_model(cell.cfg, tree_map(real, a.params())))
        else:
            out.append(tree_map(real, a))
    if cell.shape.kind == "train":
        out[1] = tree_map(torch.zeros_like, out[1])      # fresh AdamW state
    if cell.shape.kind == "decode":
        out[3] = torch.zeros_like(out[3])                # lengths
        out[4] = torch.ones_like(out[4])                 # active
        out[1] = tree_map(torch.zeros_like, out[1])      # an empty cache
    return tuple(out)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_meta_flops_equal_cpu_flops(arch, kind):
    from torch.utils.flop_counter import FlopCounterMode
    cell = _cell(arch, kind)
    args = _cpu_args(cell)
    meta = dryrun.measure(cell)["cost"]["flops"]
    with FlopCounterMode(display=False) as fc:
        cell.step_fn(*args)
    assert fc.get_total_flops() == meta


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_param_count_full_width_equals_reference(arch):
    assert specs.param_count(convert.empty_params(tconfigs.get(arch))) == \
        _reference_count(C.get(arch))


def test_argument_bytes_equal_dtensor_shards(tmp_path):
    """Rank 0's shards of every argument leaf, as ``distribute_tensor``
    cuts them on a (2, 2) mesh of a 4-rank placeholder group (and on a
    (2, 2, 1) pod mesh of 4), sum to ``argument_bytes``."""
    code = f"""
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import distribute_tensor
from repro_torch import configs
from repro_torch.launch import dryrun, specs
dryrun.placeholder_group(4)
meshes = [DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                     mesh_dim_names=("data", "model")),
          DeviceMesh("cpu", torch.arange(4).reshape(2, 2, 1),
                     mesh_dim_names=("pod", "data", "model"))]
for mesh in meshes:
    for arch in configs.ARCHS:
        cfg = configs.get_smoke(arch)
        for kind in {KINDS!r}:
            s = 32 + (cfg.num_patches if cfg.family == "vlm" else 0)
            shape = configs.ShapeSpec("x", 64 if kind == "decode" else s, 4,
                                      kind)
            cell = specs.build_cell(arch, None, mesh, cfg=cfg, shape=shape,
                                    enc_len=16)
            got = 0
            for t, sh in specs.placed_leaves(cell.args, cell.in_shardings):
                local = distribute_tensor(t, sh.mesh, sh.placements,
                                          src_data_rank=None).to_local()
                got += local.numel() * local.element_size()
            assert got == specs.argument_bytes(cell), (arch, kind, got)
print("BYTES_OK")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=180, cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert "BYTES_OK" in r.stdout, r.stdout + r.stderr


#: a record's keys: the reference's ``run_cell``'s, and ``torch``
RECORD_KEYS = {"arch", "shape", "mesh", "chips", "kind", "params", "lower_s",
               "compile_s", "tag", "memory", "cost", "collectives", "torch"}


@pytest.mark.parametrize("arch,shape", [("granite-moe-3b-a800m", "decode_32k"),
                                        ("xlstm-350m", "prefill_32k")])
def test_cli_writes_reference_records(tmp_path, arch, shape):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--both-meshes", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=180, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, r.stdout + r.stderr
    if arch == "xlstm-350m":
        assert r.stdout.count("32,765 of 32,768 steps of 1 scan(s) counted "
                              "by repetition, from step 4") == 2, r.stdout
    for name, mesh in (("16x16", FakeMesh((16, 16), ("data", "model"))),
                       ("2x16x16", FakeMesh((2, 16, 16),
                                            ("pod", "data", "model")))):
        rec = json.loads((tmp_path / f"{arch}__{shape}__{name}.json")
                         .read_text())
        assert set(rec) == RECORD_KEYS
        assert rec["torch"] == torch.__version__
        assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                      "temp_bytes", "generated_code_bytes"}
        assert set(rec["cost"]) == {"flops", "bytes_accessed",
                                    "transcendentals"}
        coll = rec["collectives"]
        assert set(coll) == {"bytes", "count", "total_bytes"}
        assert set(coll["bytes"]) == set(coll["count"]) == set(
            dryrun._COLLECTIVES)
        assert coll["total_bytes"] == sum(coll["bytes"].values()) > 0
        assert coll["count"]["all-gather"] > 0
        assert rec["chips"] == (512 if name == "2x16x16" else 256)
        cell = specs.build_cell(arch, shape, mesh)
        whole = dryrun.measure(cell)      # the FakeMesh: unpartitioned
        assert rec["params"] == cell.model_params_bytes == \
            _reference_count(C.get(arch))
        assert rec["memory"]["argument_bytes"] == \
            whole["memory"]["argument_bytes"] == specs.argument_bytes(cell)
        assert 0 < rec["memory"]["output_bytes"] <= \
            whole["memory"]["output_bytes"]
        # one device's FLOPs: its shards' products, all of them together
        # at least the whole step's
        assert 0 < rec["cost"]["flops"] < whole["cost"]["flops"] <= \
            rec["cost"]["flops"] * rec["chips"]
        assert isinstance(rec["memory"]["temp_bytes"], int)
        assert rec["memory"]["temp_bytes"] > 0
        assert rec["memory"]["generated_code_bytes"] is None


REPEATED = """
import json, sys
from repro_torch import configs
from repro_torch.launch import dryrun, mesh, specs
full = sys.argv[1] == "full"
dryrun.placeholder_group(*(() if full else (4,)))
if full:
    cell = specs.build_cell(
        "xlstm-350m", "prefill_32k",
        mesh.make_production_mesh(multi_pod=False, device="cpu"),
        shape=configs.ShapeSpec("prefill_32k", 24, 32, "prefill"))
else:
    cell = specs.build_cell(
        "xlstm-350m", None, mesh.make_debug_mesh(2, 2, device="cpu"),
        cfg=configs.get_smoke("xlstm-350m"),
        shape=configs.ShapeSpec("prefill_small", 32, 4, "prefill"))
out = {}
for repeat in (True, False):
    rec = dryrun.measure(cell, repeat_steps=repeat)
    rec.pop("lower_s")
    out[repeat] = dict(rec, repeated=rec.pop("notes")["repeated"])
print("RECORDS " + json.dumps(out))
"""


@pytest.mark.parametrize("cell,steps", [("smoke", 32), ("full", 24)])
def test_repetition_equals_every_step(cell, steps):
    """xlstm's prefill traced step by step until two steps count the same
    and the rest counted by repetition, against a trace of every step:
    every field of the record but ``lower_s`` equal.  ``smoke``: the
    smoke config on a (2, 2) mesh; ``full``: xlstm-350m at published
    widths and depth on 16x16 (``placeholder_group``'s 512 ranks), the
    global batch kept and the prompt cut to 24 tokens."""
    r = subprocess.run(
        [sys.executable, "-c", REPEATED, cell], capture_output=True,
        text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    line = [x for x in r.stdout.splitlines() if x.startswith("RECORDS ")]
    assert r.returncode == 0 and line, r.stdout + r.stderr
    got = json.loads(line[0][len("RECORDS "):])
    repeated, every = got["true"], got["false"]
    assert repeated.pop("repeated") == [[4, steps - 3, steps]]
    assert every.pop("repeated") == []
    assert repeated == every
    assert repeated["cost"]["flops"] > 0
    assert repeated["collectives"]["total_bytes"] > 0


def test_kernel_wrappers_take_the_plain_route_on_meta():
    """The LM kernels' operators take their fake implementations on a
    ``meta`` tensor (no plain version's product runs), the eGPU kernels
    their plain versions; nothing is launched."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.kernels.dot_product import ops as dops
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.kernels.wavefront_alu import ops as wops
    from repro_torch.kernels.wavefront_matmul import ops as mops
    meta = dict(device="meta")
    counters = lambda: (mops.wavefront_matmul.launches,
                        mops.wavefront_matmul.backward_launches,
                        aops.flash_attention.launches,
                        aops.flash_attention.backward_launches,
                        wops.wavefront_alu.launches,
                        dops.dot_product.launches)
    before = counters()
    seen = []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func))
            return func(*args, **(kwargs or {}))

    ops = Ops()
    ops.__enter__()
    a = torch.empty((3, 200, 64), dtype=torch.bfloat16, requires_grad=True,
                    **meta)
    b = torch.empty((3, 64, 96), dtype=torch.bfloat16, requires_grad=True,
                    **meta)
    act = torch.ones((3, 2), dtype=torch.int32, **meta)
    c = mops.wavefront_matmul(a, b, act)
    assert c.shape == (3, 200, 96) and c.device.type == "meta"
    c.sum().backward()
    assert a.grad.shape == a.shape and b.grad.shape == b.shape
    q = torch.empty((2, 4, 9, 64), requires_grad=True, **meta)
    k = torch.empty((2, 2, 9, 64), requires_grad=True, **meta)
    v = torch.empty((2, 2, 9, 64), requires_grad=True, **meta)
    o = aops.flash_attention(q, k, v)
    assert o.shape == q.shape and o.device.type == "meta"
    o.sum().backward()
    assert k.grad.shape == k.shape
    ops.__exit__(None, None, None)
    for op in ("flash_attention", "flash_attention_bwd", "wavefront_matmul",
               "wavefront_matmul_bwd"):
        assert f"repro_torch.{op}.default" in seen, (op, seen)
    assert not any(op.startswith(("aten.bmm", "aten.mm")) for op in seen)
    x = torch.empty((16, 8), **meta)
    assert wops.wavefront_alu(x, x, x, torch.ones((2,), dtype=torch.int32,
                                                  **meta), "add").shape \
        == (16, 8)
    assert dops.dot_product(x, x, torch.ones((2,), dtype=torch.int32,
                                             **meta)).device.type == "meta"
    assert counters() == before
