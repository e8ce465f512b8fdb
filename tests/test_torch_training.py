"""The port's training path against the JAX reference's, on the CPU.

* ``optimizer.apply`` on identical gradients and state against the
  reference's (rtol 1e-6: the same float32 arithmetic in the same order;
  the norm sums the leaves in another order), over several counts;
* ``compression`` and ``SyntheticLM`` bit for bit;
* ``repro_torch.launch.train.main`` (``--init numpy``) against the
  reference's training loop on the same numpy weights and batches, step
  by step, and against the committed ``src/repro_torch/training/
  reference_train.json`` (which ``chip_smoke.py`` holds the card's run
  against): each step's loss, gradient norm and learning rate within
  ``train.TOLERANCE``.  Losses are compared per step, not parameters
  after several steps (AdamW turns tiny gradient differences on
  near-zero gradients into steps of about ``lr``);
* the port of every test in ``tests/test_training.py`` and of the two
  train tests of ``tests/test_system.py``, on the port's CPU path.

Regenerate the reference file (and the reference weights its runs name)
with ``PYTHONPATH=src python tests/test_torch_training.py --write``.
"""
import json
import os
import sys

import numpy as np
import pytest
from _hyp import given, settings, st

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.training import compression as rcomp, data as rdata  # noqa: E402
from repro.training import optimizer as ropt  # noqa: E402
from repro.training.steps import make_train_step as rmake  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import api as tapi, convert  # noqa: E402
from repro_torch.training import checkpoint, compression, data  # noqa: E402
from repro_torch.training import optimizer as opt_mod  # noqa: E402
from repro_torch.training.steps import TrainSettings, make_train_step  # noqa: E402

CPU = torch.device("cpu")
#: the committed reference runs: smoke configs, ``--init numpy``
REF = dict(steps=5, batch=4, seq=32, lr=1e-3, seed=0)
REF_RUNS = [(a, d) for a in ("granite-moe-3b-a800m", "yi-9b")
            for d in ("float32", "bfloat16")]
#: the other families' runs in the same file, after ``REF_RUNS``
#: (``tests/test_torch_families_train.py`` holds them)
FAMILY_RUNS = [(a, d) for a in ("zamba2-1p2b", "xlstm-350m",
                                "seamless-m4t-large-v2", "internvl2-2b")
               for d in ("float32", "bfloat16")]
#: what a run of the reference file holds besides its metrics, and why
#: (``launch/train.py``'s ``held`` reads it); ``--write`` puts it there
HOLD = {
    ("xlstm-350m", "float32"): {
        "rtol": {"grad_norm": 5e-4},
        "why": "from step 1 (step 0 has the same weights in both packages) "
               "the gradient norm within 5e-4: xlstm's stabilisers are "
               "running sums inside exp (the reason its forward's float32 "
               "bound is loosened, tests/test_torch_families.py), and "
               "AdamW's first steps move every weight by about lr whatever "
               "the size of its gradient, so gradients equal to 1e-5 give "
               "weights that part by a few ulps; at step 3, where the "
               "gradient norm doubles, the norms part by 2.5e-4 on the CPU "
               "and 3.4e-4 on an H100; on the reference's own weights the "
               "port's norm is within 1.6e-5 of the reference's at every "
               "step"},
    ("xlstm-350m", "bfloat16"): {
        "weights": "reference_weights_xlstm-350m_bfloat16.npz",
        "why": "the gradient norm held on the run's trajectory at step 0 "
               "only, and at every step on the reference's own weights "
               "(weights: the reference's parameters after each step): a "
               "bfloat16 trajectory of xlstm follows where it rounds "
               "(AdamW's first steps turn rounding-sized gradient "
               "differences into weight steps of about lr, and the "
               "stabilisers are running sums inside exp); the reference's "
               "own bfloat16 run is 0.83 of its gradient norm from its "
               "float32 run at step 3, and the port's bfloat16 runs, the "
               "same code on the CPU and on an H100, part by 14 % at step "
               "2; the loss and the learning rate hold at every step"},
}


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny tensors: one intra-op thread (restored after the test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch="yi_9b", **okw):
    cfg = tconfigs.get_smoke(arch)
    ocfg = opt_mod.OptConfig(lr=1e-3, warmup_steps=5, total_steps=100, **okw)
    model = ttrain.build_model(cfg, 0, CPU)
    opt = opt_mod.init(dict(model.named_parameters()), ocfg)
    return cfg, ocfg, model, opt


def _batch(ds, i):
    return {k: torch.from_numpy(v) for k, v in ds.next_batch(i).items()}


# --- optimizer, compression, data against the reference ---------------------

def test_optimizer_apply_equals_reference():
    """The same parameters, gradients and state through both packages'
    ``apply``, four steps at counts around the end of warm-up (each step
    fed the reference's previous outputs)."""
    rng = np.random.default_rng(0)
    shapes = {"w": (6, 5), "b": (5,), "blocks.0.ln": (5,)}
    ocfg_r = ropt.OptConfig(lr=1e-2, warmup_steps=3, total_steps=8)
    ocfg_t = opt_mod.OptConfig(lr=1e-2, warmup_steps=3, total_steps=8)
    # the reference's block leaves are layer-stacked: "blocks.0.ln" is
    # (1, 5) there, so it decays as a matrix does
    rshape = {"w": (6, 5), "b": (5,), "blocks.0.ln": (1, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    state = {"m": {k: np.zeros(s, np.float32) for k, s in shapes.items()},
             "v": {k: np.zeros(s, np.float32) for k, s in shapes.items()},
             "count": np.int32(0)}
    for step in range(4):
        grads = {k: (rng.standard_normal(s) * 10 ** -step).astype(np.float32)
                 for k, s in shapes.items()}
        rp, rs, rinfo = ropt.apply(
            {k: jnp.asarray(v.reshape(rshape[k])) for k, v in params.items()},
            {k: jnp.asarray(v.reshape(rshape[k])) for k, v in grads.items()},
            {"m": {k: jnp.asarray(v.reshape(rshape[k]))
                   for k, v in state["m"].items()},
             "v": {k: jnp.asarray(v.reshape(rshape[k]))
                   for k, v in state["v"].items()},
             "count": jnp.asarray(state["count"])}, ocfg_r)
        tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        ts = {"m": {k: torch.from_numpy(v.copy())
                    for k, v in state["m"].items()},
              "v": {k: torch.from_numpy(v.copy())
                    for k, v in state["v"].items()},
              "count": torch.tensor(int(state["count"]), dtype=torch.int32)}
        tg = {k: torch.from_numpy(v) for k, v in grads.items()}
        tp, ts, tinfo = opt_mod.apply(tp, tg, ts, ocfg_t,
                                      stacked=("blocks",))
        assert not tg                            # the gradients are consumed
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tinfo[key]), float(rinfo[key]),
                                       rtol=1e-6)
        assert int(ts["count"]) == int(rs["count"]) == step + 1
        for k in shapes:
            for got, exp in ((tp[k], rp[k]), (ts["m"][k], rs["m"][k]),
                             (ts["v"][k], rs["v"][k])):
                np.testing.assert_allclose(
                    got.numpy(), np.asarray(exp).reshape(shapes[k]),
                    rtol=1e-6, atol=1e-9, err_msg=f"step {step} {k}")
        params = {k: np.asarray(rp[k]).reshape(shapes[k]) for k in shapes}
        state = {"m": {k: np.asarray(rs["m"][k]).reshape(shapes[k])
                       for k in shapes},
                 "v": {k: np.asarray(rs["v"][k]).reshape(shapes[k])
                       for k in shapes},
                 "count": np.int32(rs["count"])}


def test_optimizer_sentinel_skips_the_whole_update():
    p = {"w": torch.ones((3, 2))}
    ocfg = opt_mod.OptConfig()
    state = opt_mod.init(p, ocfg)
    _, state, info = opt_mod.apply(p, {"w": torch.ones((3, 2))}, state, ocfg,
                                   stacked=(),
                                   loss=torch.tensor(float("nan")))
    assert not bool(info["finite"])
    assert torch.equal(p["w"], torch.ones((3, 2)))
    assert int(state["count"]) == 0 and not torch.count_nonzero(
        state["m"]["w"])


def test_schedule_equals_reference():
    ocfg_r = ropt.OptConfig(lr=3e-4, warmup_steps=10, total_steps=50)
    ocfg_t = opt_mod.OptConfig(lr=3e-4, warmup_steps=10, total_steps=50)
    for c in (0, 1, 5, 9, 10, 11, 30, 49, 50, 70):
        np.testing.assert_allclose(
            float(opt_mod.schedule(ocfg_t, torch.tensor(c, dtype=torch.int32))),
            float(ropt.schedule(ocfg_r, jnp.int32(c))), rtol=1e-6)


def test_compression_equals_reference_bit_for_bit():
    rng = np.random.default_rng(1)
    ties = np.array([127.0, 2.5, -3.5, 0.5, 1.5], np.float32)  # scale 1:
    for x in [ties] + [(rng.standard_normal(300) * scale).astype(np.float32)
                       for scale in (1e-3, 1.0, 50.0)]:   # halves to even
        q, s = compression.quantize(torch.from_numpy(x))
        rq, rs = rcomp.quantize(jnp.asarray(x))
        assert np.array_equal(q.numpy(), np.asarray(rq))
        assert np.float32(s) == np.float32(rs)
        assert np.array_equal(compression.dequantize(q, s).numpy(),
                              np.asarray(rcomp.dequantize(rq, rs)))
    g = {"a": rng.standard_normal((4, 5)).astype(np.float32),
         "b": rng.standard_normal(7).astype(np.float32)}
    r = {k: (rng.standard_normal(v.shape) * 1e-3).astype(np.float32)
         for k, v in g.items()}
    rg, rr = rcomp.apply_error_feedback(
        {k: jnp.asarray(v) for k, v in g.items()},
        {k: jnp.asarray(v) for k, v in r.items()})
    tg, tr = compression.apply_error_feedback(
        {k: torch.from_numpy(v.copy()) for k, v in g.items()},
        {k: torch.from_numpy(v.copy()) for k, v in r.items()})
    for k in g:
        assert np.array_equal(tg[k].numpy(), np.asarray(rg[k]))
        assert np.array_equal(tr[k].numpy(), np.asarray(rr[k]))


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "yi-9b",
                                  "seamless-m4t-large-v2", "internvl2-2b",
                                  "zamba2-1p2b", "xlstm-350m"])
def test_synthetic_lm_equals_reference_bit_for_bit(arch):
    ours = data.SyntheticLM(tconfigs.get_smoke(arch), 3, 20, seed=5)
    theirs = rdata.SyntheticLM(rconfigs.get_smoke(arch), 3, 20, seed=5)
    for step in (0, 7):
        a, b = ours.next_batch(step), theirs.next_batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


# --- the training driver against the reference -------------------------------

def reference_run(arch, dtype, train_settings=None, weights=None, **flags):
    """The reference driver's loop (``repro/launch/train.py``) on the numpy
    weights: each step's (loss, grad_norm, lr); ``train_settings``: the
    reference's ``TrainSettings``; ``weights``, a list, gets the
    parameters (numpy trees) that each step from step 1 starts from."""
    f = dict(REF, **flags)
    cfg = rconfigs.get_smoke(arch).replace(dtype=getattr(jnp, dtype))
    tcfg = tconfigs.get_smoke(arch).replace(dtype=getattr(torch, dtype))
    params = jax.tree.map(jnp.asarray, convert.numpy_params(tcfg, f["seed"]))
    ocfg = ropt.OptConfig(lr=f["lr"], warmup_steps=min(20, f["steps"]),
                          total_steps=f["steps"], state_dtype=cfg.param_dtype)
    opt = ropt.init(params, ocfg)
    step = jax.jit(rmake(cfg, ocfg, *(() if train_settings is None
                                      else (train_settings,))),
                   donate_argnums=(0, 1))
    ds = rdata.SyntheticLM(cfg, f["batch"], f["seq"], seed=f["seed"])
    out = {"loss": [], "grad_norm": [], "lr": []}
    for i in range(f["steps"]):
        batch = {k: jnp.asarray(v) for k, v in ds.next_batch(i).items()}
        params, opt, _, m = step(params, opt, batch, None)
        for k in out:
            out[k].append(float(m[k]))
        if weights is not None and i + 1 < f["steps"]:
            weights.append(jax.tree.map(np.array, params))
    return out


def test_port_cpu_run_holds_against_reference_file():
    """The check ``chip_smoke.py`` makes on the card, here on the CPU
    (granite's and yi's runs; the other families' are
    ``tests/test_torch_families_train.py``'s)."""
    out = ttrain.hold_against_reference(CPU, archs={a for a, _ in REF_RUNS})
    assert set(out) == {f"{a} {d}" for a, d in REF_RUNS}


def test_reference_train_file_is_current():
    """The committed file is the reference's run (each metric to float32
    rounding noise of a rerun): granite's and yi's runs here, the other
    families' in ``tests/test_torch_families_train.py``."""
    ref = json.loads(ttrain.REFERENCE.read_text())
    assert {k: ref[k] for k in REF} == REF
    assert [(r["arch"], r["dtype"]) for r in ref["runs"]] == \
        REF_RUNS + FAMILY_RUNS
    for run in ref["runs"][:len(REF_RUNS)]:
        exp = reference_run(run["arch"], run["dtype"])
        for k, v in exp.items():
            np.testing.assert_allclose(run[k], v, rtol=1e-6,
                                       err_msg="regenerate with --write")


def test_train_main_steps_equal_reference_float32():
    """``main`` with the reference driver's flags beside the reference's
    loop, another batch and sequence than the file's."""
    flags = dict(batch=2, seq=24, steps=4)
    exp = reference_run("granite-moe-3b-a800m", "float32", **flags)
    rec = {}
    ttrain.main(["--arch", "granite-moe-3b-a800m", "--smoke", "--steps", "4",
                 "--batch", "2", "--seq", "24", "--device", "cpu", "--init",
                 "numpy", "--dtype", "float32", "--log-every", "100"],
                record=rec)
    for k, v in exp.items():
        np.testing.assert_allclose([r[k] for r in rec["steps"]], v,
                                   rtol=1e-4)


def test_train_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        ttrain.main(["--arch", "yi-9b", "--smoke", "--steps", "1"])


# --- the port of tests/test_training.py --------------------------------------

def test_loss_descends_on_synthetic_bigrams():
    cfg, ocfg, model, opt = _setup()
    step = make_train_step(cfg, ocfg)
    ds = data.SyntheticLM(cfg, batch=8, seq=32)
    losses = []
    for i in range(40):
        model, opt, _, m = step(model, opt, _batch(ds, i), None)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05


def test_nan_sentinel_skips_update():
    cfg, ocfg, model, opt = _setup()
    step = make_train_step(cfg, ocfg)
    ds = data.SyntheticLM(cfg, batch=4, seq=16)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(float("nan"))
    before = [p.detach().clone() for p in model.parameters()]
    model, new_opt, _, m = step(model, opt, _batch(ds, 0), None)
    assert float(m["finite"]) == 0.0
    # params passed through unchanged (not updated with NaN gradients)
    for a, b in zip(model.parameters(), before):
        assert a.shape == b.shape
        assert torch.equal(a.isnan(), b.isnan())
    # the whole update is skipped, count included (retry-same-step policy)
    assert int(new_opt["count"]) == 0


def test_checkpoint_roundtrip(tmp_path):
    cfg, ocfg, model, opt = _setup()
    params = dict(model.named_parameters())
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, 7, (params, opt))
    assert checkpoint.latest_step(path) == 7
    (p2, o2), step, _ = checkpoint.restore(path, (params, opt))
    assert step == 7
    for k, v in params.items():
        assert torch.equal(v.detach(), p2[k])
    assert torch.equal(o2["count"], opt["count"])


def test_checkpoint_async_and_atomicity(tmp_path):
    cfg, ocfg, model, opt = _setup()
    params = dict(model.named_parameters())
    path = str(tmp_path / "ckpt")
    t = checkpoint.save_async(path, 3, params)
    with torch.no_grad():       # the snapshot was taken before this update
        params["embed"].add_(1.0)
    t.join()
    assert checkpoint.latest_step(path) == 3
    p3, _, _ = checkpoint.restore(path, params)
    assert torch.equal(p3["embed"] + 1.0, params["embed"].detach())
    # a later save supersedes atomically
    checkpoint.save(path, 5, params)
    assert checkpoint.latest_step(path) == 5
    assert not any(f.startswith("ckpt.tmp") for f in os.listdir(tmp_path))


def test_checkpoint_keeps_bfloat16_leaves(tmp_path):
    x = {"m": torch.randn(5, 3).to(torch.bfloat16), "n": np.arange(4)}
    checkpoint.save(str(tmp_path), 1, x)
    y, _, _ = checkpoint.restore(str(tmp_path), x)
    assert y["m"].dtype == torch.bfloat16 and torch.equal(y["m"], x["m"])
    assert np.array_equal(y["n"], x["n"])
    meta = json.loads((tmp_path / "step_00000001" / "manifest.json")
                      .read_text())
    assert [m["dtype"] for m in meta["leaves"]] == ["bfloat16", "int64"]


def test_train_driver_recovers_from_injected_fault(tmp_path):
    """End-to-end fault tolerance: NaN injection mid-run -> auto restore."""
    losses = ttrain.main([
        "--arch", "yi-9b", "--smoke", "--steps", "16", "--batch", "4",
        "--seq", "16", "--ckpt-dir", str(tmp_path / "ck"),
        "--ckpt-every", "5", "--inject-nan-at", "8", "--log-every", "100",
        "--device", "cpu"])
    assert len(losses) >= 14            # run completed despite the fault
    assert np.isfinite(losses).all()


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=20, deadline=None)
def test_quantize_roundtrip_bounded_error(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal(256)
                          * rng.uniform(0.01, 10)).astype(np.float32))
    q, s = compression.quantize(x)
    err = (compression.dequantize(q, s) - x).abs().numpy()
    assert err.max() <= float(s) * 0.5 + 1e-7   # half-ulp of the int8 grid


def test_error_feedback_accumulates_to_unbiased():
    """EF property: the running sum of compressed grads tracks the running
    sum of true grads (quantisation error does not accumulate)."""
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy((rng.standard_normal(64) * 0.1)
                              .astype(np.float32))
    residual = {"w": torch.zeros(64)}
    total = torch.zeros(64)
    for _ in range(50):
        g_c, residual = compression.apply_error_feedback(
            {"w": g_true.clone()}, residual)
        total = total + g_c["w"]
    np.testing.assert_allclose((total / 50).numpy(), g_true.numpy(),
                               atol=2e-3)


def test_compressed_training_still_converges():
    cfg, ocfg, model, opt = _setup()
    step = make_train_step(cfg, ocfg, TrainSettings(compress_grads=True))
    residual = compression.init_residual(dict(model.named_parameters()))
    ds = data.SyntheticLM(cfg, batch=8, seq=32)
    losses = []
    for i in range(30):
        model, opt, residual, m = step(model, opt, _batch(ds, i), residual)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_microbatch_drop_stale_rescales_correctly():
    cfg, ocfg, model, opt = _setup()
    step = make_train_step(cfg, ocfg, TrainSettings(
        microbatches=4, straggler_mitigation=True))
    ds = data.SyntheticLM(cfg, batch=8, seq=16)
    batch = _batch(ds, 0)
    full = dict(batch, microbatch_keep=torch.ones(4))
    # drop the last microbatch (straggler): loss over kept 3 only
    dropped = dict(batch, microbatch_keep=torch.tensor([1., 1., 1., 0.]))
    losses = {}
    for name, b in (("full", full), ("drop", dropped)):
        _, _, model_, opt_ = _setup()
        _, _, _, m = step(model_, opt_, b, None)
        losses[name] = float(m["loss"])
    assert np.isfinite(losses["drop"])
    # kept-mean differs from full-mean but is the same scale
    assert abs(losses["drop"] - losses["full"]) < 1.0
    # and it is the mean of the three kept microbatches' losses
    model_ = ttrain.build_model(cfg, 0, CPU)
    with torch.no_grad():
        parts = [float(tapi.loss(cfg, model_, {"tokens": t}))
                 for t in batch["tokens"].reshape(4, 2, -1)[:3]]
    np.testing.assert_allclose(losses["drop"], np.mean(parts), rtol=1e-5)


# --- the port of tests/test_system.py's train tests --------------------------

def test_train_driver_end_to_end(tmp_path):
    losses = ttrain.main([
        "--arch", "granite-moe-3b-a800m", "--smoke", "--steps", "12",
        "--batch", "4", "--seq", "16", "--log-every", "100",
        "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "6",
        "--device", "cpu"])
    assert len(losses) == 12 and np.isfinite(losses).all()


def test_train_driver_resume(tmp_path):
    ck = str(tmp_path / "ck")
    ttrain.main(["--arch", "yi-9b", "--smoke", "--steps", "6",
                 "--batch", "2", "--seq", "16", "--ckpt-dir", ck,
                 "--ckpt-every", "3", "--log-every", "100", "--device", "cpu"])
    losses = ttrain.main(["--arch", "yi-9b", "--smoke", "--steps", "9",
                          "--batch", "2", "--seq", "16", "--ckpt-dir", ck,
                          "--resume", "--log-every", "100", "--device", "cpu"])
    assert len(losses) >= 3           # resumed from step 6, ran to 9


def _write():
    runs = []
    for arch, dtype in REF_RUNS + FAMILY_RUNS:
        hold = HOLD.get((arch, dtype), {})
        trees = []
        runs.append({"arch": arch, "dtype": dtype,
                     **reference_run(arch, dtype, weights=trees), **hold})
        if "weights" in hold:
            ttrain.save_weights(ttrain.REFERENCE.parent / hold["weights"],
                                trees)
    doc = {**REF, "made_by": "tests/test_torch_training.py --write (JAX "
           "reference, repro.launch.train's loop, numpy_params weights, "
           "SyntheticLM batches)", "runs": runs}
    ttrain.REFERENCE.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"wrote {ttrain.REFERENCE}")


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit("usage: PYTHONPATH=src python tests/test_torch_training.py "
                 "--write")
    _write()
