"""The training of zamba2, xlstm, seamless-m4t and internvl2 against the
JAX reference's, on the CPU.

* ``src/repro_torch/training/reference_train.json``'s eight runs of these
  families (smoke configs, float32 and bfloat16, 5 steps of 4 x 32
  tokens, ``--init numpy``) are a rerun of the reference's loop
  (``tests/test_torch_training.py``'s ``reference_run``, rtol 1e-6);
* ``launch.train.hold_against_reference`` on the CPU holds the port's
  runs to them, every step's metrics within ``train.TOLERANCE``
  relative, but where a run of the file says otherwise, beside its
  measured reason (``why``; ``test_torch_training.HOLD`` writes it):
  xlstm's float32 gradient norm from step 1 within 5e-4; xlstm's
  bfloat16 gradient norm on the run's own trajectory at step 0 only, and
  at every step on the reference's own weights (the file's ``weights``);
* on the reference's own weights at each step of xlstm's runs the port's
  gradient is the reference's: in float32 its norm within 1e-4; in
  bfloat16 its norm within ``train.TOLERANCE`` and the whole gradient no
  further from the reference's bfloat16 gradient than that is from the
  reference's float32 gradient on the same weights;
* one AdamW step decays the leaves the reference decays (its stacked
  parts' vectors, not xlstm's per-layer list's);
* ``launch.train.main --arch <family> --smoke --device cpu`` trains each
  family, and ``--microbatches 2`` (frames split with the tokens) equals
  the reference's loop with ``TrainSettings(microbatches=2)``.
"""
import functools
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.training import data as rdata, optimizer as ropt  # noqa: E402
from repro.training.steps import TrainSettings as RSettings  # noqa: E402
from repro.training.steps import make_train_step as rmake  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import api as tapi, convert, transformer  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from test_torch_training import (FAMILY_RUNS, HOLD, REF,  # noqa: E402
                                 reference_run)

CPU = torch.device("cpu")
ARCHS = list(dict.fromkeys(a for a, _ in FAMILY_RUNS))


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny tensors: one intra-op thread (restored after the test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _runs() -> dict:
    ref = json.loads(ttrain.REFERENCE.read_text())
    return {(r["arch"], r["dtype"]): r for r in ref["runs"]}


def _leaves(tree) -> dict:
    """A tree's leaves by path, as numpy arrays."""
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch,dtype", FAMILY_RUNS)
def test_reference_train_file_is_current(arch, dtype):
    """The family's run in the committed file is the reference's (each
    metric to float32 rounding noise of a rerun), with what
    ``test_torch_training.HOLD`` says of it; the weights it names are the
    rerun's parameters at bfloat16 (one bfloat16 ulp: a rerun may round
    the other way at a tie)."""
    run = _runs()[(arch, dtype)]
    trees = []
    exp = reference_run(arch, dtype, weights=trees)
    for k, v in exp.items():
        np.testing.assert_allclose(run[k], v, rtol=1e-6,
                                   err_msg="regenerate with tests/"
                                   "test_torch_training.py --write")
    assert {k: v for k, v in run.items() if k not in
            ("arch", "dtype", *exp)} == HOLD.get((arch, dtype), {})
    if "weights" in run:
        tcfg = tconfigs.get_smoke(arch)
        stored = ttrain.load_weights(ttrain.REFERENCE.parent
                                     / run["weights"], tcfg, REF["seed"],
                                     REF["steps"])
        assert len(stored) == len(trees) + 1
        for got, tree in zip(stored[1:], trees):
            for k, v in _leaves(tree).items():
                np.testing.assert_allclose(_leaves(got)[k], v,
                                           rtol=2 ** -8, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_cpu_run_holds_against_reference_file(arch):
    """The check ``chip_smoke.py`` makes on the card, here on the CPU:
    both types of the family's run, every step held.  xlstm's bfloat16
    run is held on the reference's own weights, as its trajectory's
    gradient norm leaves ``train.TOLERANCE`` (at step 3: 0.17, where the
    reference's own bfloat16 run is 0.83 of its value from its float32
    run)."""
    out = ttrain.hold_against_reference(CPU, archs={arch})
    assert set(out) == {f"{arch} float32", f"{arch} bfloat16"}
    bf = out[f"{arch} bfloat16"]
    assert all(bf[k] <= t for k, t in
               ttrain.TOLERANCE["bfloat16"].items()), bf
    assert ("on_weights" in bf) == (arch == "xlstm-350m")
    if arch == "xlstm-350m":
        assert max(bf["trajectory"]) > \
            ttrain.TOLERANCE["bfloat16"]["grad_norm"], bf
        assert len(bf["gap"]["grad_norm"]) == REF["steps"]


def test_held_reads_the_runs_own_bounds():
    """``train.held``: every step within ``TOLERANCE``, from step 1 within
    the run's ``rtol`` where it gives one; a run with ``weights`` has its
    gradient norm held at step 0 only (the rest is held on the
    reference's weights), its loss at every step."""
    run = {"dtype": "float32", "grad_norm": [10.0] * 3, "loss": [10.0] * 3}
    held = lambda got, key="grad_norm", **kw: ttrain.held(
        {**run, **kw}, key, np.array(got)).tolist()
    got = [10.0 * (1 + 2e-4)] * 3
    assert held(got) == [False] * 3
    assert held(got, rtol={"grad_norm": 5e-4}) == [False, True, True]
    assert held(got, "loss", rtol={"grad_norm": 5e-4}) == [False] * 3
    bf = dict(dtype="bfloat16", weights="w.npz")
    assert held([10.4, 10.6, 9.4], dtype="bfloat16") == [True, False, False]
    assert held([10.6, 18.0, 2.0], **bf) == [False, True, True]
    assert held([10.4, 18.0, 2.0], **bf) == [True, True, True]
    assert held([10.0, 10.0, 10.3], "loss", **bf) == [True, True, False]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlstm_gradient_on_reference_weights_every_step(dtype):
    """The port's gradient on the reference's own weights at each step of
    xlstm's smoke run (``dtype``'s), against the reference's on the same
    weights and batch.  float32: the norm within 1e-4 (1.6e-5 at most,
    step 3): the gradient is the reference's at every step; the
    trajectories part (the file's ``rtol``).  bfloat16: the loss and the
    norm within ``train.TOLERANCE`` (the norm 1.5e-2 at most), and the
    whole gradient no further from the reference's bfloat16 gradient
    than that is from the reference's float32 gradient on the same
    weights (0.55 of it at most); the port's gradient from these weights
    rounded to bfloat16 is its gradient from them, bit for bit (a
    bfloat16 run reads them only as bfloat16, so the file's ``weights``
    keep them so)."""
    arch = "xlstm-350m"
    cfg = rconfigs.get_smoke(arch).replace(dtype=getattr(jnp, dtype))
    tcfg = tconfigs.get_smoke(arch).replace(dtype=getattr(torch, dtype))
    params = jax.tree.map(jnp.asarray, convert.numpy_params(tcfg, REF["seed"]))
    ocfg = ropt.OptConfig(lr=REF["lr"], warmup_steps=REF["steps"],
                          total_steps=REF["steps"])
    opt = ropt.init(params, ocfg)
    step = jax.jit(rmake(cfg, ocfg))
    grad = {d: jax.jit(jax.grad(functools.partial(
        rapi.loss, cfg.replace(dtype=getattr(jnp, d)))))
        for d in ("float32", "bfloat16")}
    ds = rdata.SyntheticLM(cfg, REF["batch"], REF["seq"], seed=REF["seed"])
    tol = ttrain.TOLERANCE[dtype]

    def port(tree, batch):
        model = convert.from_reference(tcfg, tree).requires_grad_()
        loss = tapi.loss(tcfg, model, batch)
        loss.backward()
        return loss.detach(), model

    for i in range(REF["steps"]):
        batch = {k: jnp.asarray(v) for k, v in ds.next_batch(i).items()}
        tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
        tree = jax.tree.map(lambda a: np.array(a, np.float32), params)
        loss, model = port(tree, tbatch)
        got = topt.global_norm(p.grad for p in model.parameters())
        if dtype == "bfloat16":
            ref_bf, ref_f32 = (_leaves(grad[d](params, batch))
                               for d in ("bfloat16", "float32"))
        params, opt, _, m = step(params, opt, batch, None)
        np.testing.assert_allclose(float(got), float(m["grad_norm"]),
                                   rtol=tol["grad_norm"], err_msg=f"step {i}")
        if dtype == "float32":
            continue
        np.testing.assert_allclose(float(loss), float(m["loss"]),
                                   rtol=tol["loss"], err_msg=f"step {i}")
        ours = _leaves(convert.to_reference(transformer.tree_map(
            lambda t: t.grad, model.params()), tcfg))
        dist = lambda a, b: np.sqrt(sum(
            np.sum((np.float64(a[k]) - b[k]) ** 2) for k in a))
        assert ours.keys() == ref_bf.keys()
        assert dist(ours, ref_bf) <= dist(ref_bf, ref_f32), f"step {i}"
        rounded = jax.tree.map(lambda a: torch.from_numpy(a).to(
            torch.bfloat16).float().numpy(), tree)
        rloss, rmodel = port(rounded, tbatch)
        assert torch.equal(rloss, loss)
        assert all(torch.equal(a.grad, b.grad) for a, b in
                   zip(rmodel.parameters(), model.parameters()))


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_decay_follows_reference_layout(arch):
    """One AdamW step on the numpy weights with the same gradients in both
    packages: every leaf equals the reference's, so each decays where the
    reference's does (a vector of a stacked part, as zamba2's ``mamba`` or
    seamless's ``enc``/``dec`` norm scales, decays; one of xlstm's layer
    list or zamba2's ``shared_attn`` does not)."""
    tcfg = tconfigs.get_smoke(arch)
    tree = convert.numpy_params(tcfg, 0)
    rng = np.random.default_rng(1)
    grads = jax.tree.map(lambda a: rng.standard_normal(a.shape)
                         .astype(np.float32), tree)
    ocfg_r = ropt.OptConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    rp, _, _ = ropt.apply(jax.tree.map(jnp.asarray, tree),
                          jax.tree.map(jnp.asarray, grads),
                          ropt.init(jax.tree.map(jnp.asarray, tree), ocfg_r),
                          ocfg_r)
    model = convert.from_reference(tcfg, jax.tree.map(np.copy, tree))
    named = dict(model.named_parameters())
    gmodel = convert.from_reference(tcfg, grads)
    tg = {k: p.detach().clone() for k, p in gmodel.named_parameters()}
    ocfg_t = topt.OptConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    topt.apply(named, tg, topt.init(named, ocfg_t), ocfg_t,
               stacked=convert.stacked_parts(tcfg))
    got = convert.to_reference(model)
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])
    exp = flat(jax.tree.map(np.asarray, rp))
    got = flat(got)
    assert got.keys() == exp.keys()
    for k in exp:
        np.testing.assert_allclose(got[k], exp[k], rtol=1e-6, atol=1e-7,
                                   err_msg=jax.tree_util.keystr(k))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_main_trains_each_family(arch):
    """``launch/train.py --arch <family> --smoke --device cpu`` (weights
    from a ``torch.Generator``, frames or patches moved to the device
    with the tokens): finite losses, every step taken."""
    rec = {}
    losses = ttrain.main(["--arch", arch, "--smoke", "--steps", "3",
                          "--batch", "2", "--seq", "16", "--device", "cpu",
                          "--log-every", "100"], record=rec)
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert all(r["finite"] for r in rec["steps"])


def test_microbatches_split_frames_as_the_reference():
    """``--microbatches 2`` on seamless-m4t (the frames split with the
    tokens) against the reference's loop with ``TrainSettings(
    microbatches=2)``, float32, each step's metrics within 1e-4 (a frame
    batch not split with the tokens would not meet the decoder's rows in
    the cross-attention)."""
    arch, flags = "seamless-m4t-large-v2", dict(steps=3, batch=4, seq=16)
    exp = reference_run(arch, "float32", RSettings(microbatches=2), **flags)
    rec = {}
    ttrain.main(["--arch", arch, "--smoke", "--steps", "3", "--batch", "4",
                 "--seq", "16", "--microbatches", "2", "--device", "cpu",
                 "--init", "numpy", "--dtype", "float32", "--log-every",
                 "100"], record=rec)
    for k, v in exp.items():
        np.testing.assert_allclose([r[k] for r in rec["steps"]], v,
                                   rtol=1e-4, err_msg=k)
