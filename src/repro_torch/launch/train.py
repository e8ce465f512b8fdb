"""End-to-end training driver: the port of ``repro/launch/train.py``.

The reference's flags and loop (synthetic data, AdamW, checkpoints with
auto-restore, the non-finite sentinel with retry from a checkpoint,
async saves, optional gradient compression and microbatches), on the
card by default:

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-3b-a800m --batch 8 --seq 512 --steps 6

``--device cpu`` runs on the CPU (with the kernels' plain versions);
without it the run needs a CUDA device.  ``--init numpy`` takes the
weights of :func:`repro_torch.models.convert.numpy_params`, which a JAX
reference run can be given too; the default draws them on the device
from a ``torch.Generator``.  ``--dtype`` sets the activation type (the
master parameters and the optimizer state stay at the config's
``param_dtype``).  ``main`` returns the losses, and fills ``record``,
when given, with each step's loss, gradient norm, learning rate and
seconds (host clock, the step's work on the device included: reading
its loss waits for it), and with the run's end state under ``"state"``
(the model, the optimizer state, the step function and the data
stream), so a caller can go on stepping, or profile a step.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import torch

from .. import configs
from ..models import api, convert
from ..training import checkpoint, compression, data, optimizer as opt_mod
from ..training.steps import TrainSettings, make_train_step
from .serve import DTYPES, _sync, float32_matmuls, resolve_device


#: the JAX reference's smoke training runs (each step's loss, gradient
#: norm and learning rate), written by ``tests/test_torch_training.py
#: --write``
REFERENCE = pathlib.Path(__file__).resolve().parents[1] / "training" \
    / "reference_train.json"
#: activation type -> relative tolerance of each step's metric against the
#: reference's.  float32: the same arithmetic summed in other orders
#: (1e-6 on the CPU).  bfloat16: the two packages round to bf16 at other
#: places (the reference rounds the softmax weights before ``@ v``, the
#: kernels keep them in float32) and the drift is one bf16 ulp (2^-8
#: relative) here and there: the loss, a mean over every token, moves by
#: far less than an ulp (1e-4 on the CPU), the gradient norm by a few
#: tenths of one (5e-3 on the CPU)
TOLERANCE = {"float32": {"loss": 1e-4, "grad_norm": 1e-4, "lr": 1e-4},
             "bfloat16": {"loss": 2e-3, "grad_norm": 5e-2, "lr": 1e-4}}


def build_model(cfg, seed: int, device, init: str = "torch"):
    """The trainable model: the reference's draws at ``cfg.param_dtype``
    (the master copy), from a ``torch.Generator`` on ``device`` or, with
    ``init="numpy"``, from :func:`convert.numpy_params`."""
    if init == "numpy":
        model = convert.from_reference(cfg, convert.numpy_params(cfg, seed),
                                       device)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        model = api.init_params(gen, cfg, device)
    return model.requires_grad_()


@torch.no_grad()
def _load_into(dst, src) -> None:
    """Copy a restored tree into the live one, leaf by leaf, in place."""
    if isinstance(dst, dict):
        for k in dst:
            _load_into(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _load_into(d, s)
    else:
        dst.copy_(src)


def main(argv=None, record: dict | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--inject-nan-at", type=int, default=-1,
                    help="fault-injection test hook")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=sorted(DTYPES),
                    help="activation type (default: the config's)")
    ap.add_argument("--init", choices=("torch", "numpy"), default="torch")
    ap.add_argument("--layers", type=int, default=None,
                    help="the config's depth cut to this many layers "
                         "(n_layers), its widths kept")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    float32_matmuls()
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    if args.dtype:
        cfg = cfg.replace(dtype=DTYPES[args.dtype])
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    ocfg = opt_mod.OptConfig(lr=args.lr, warmup_steps=min(20, args.steps),
                             total_steps=args.steps,
                             state_dtype=cfg.param_dtype)
    settings = TrainSettings(microbatches=args.microbatches,
                             compress_grads=args.compress_grads)

    model = build_model(cfg, args.seed, device, args.init)
    params = dict(model.named_parameters())
    opt_state = opt_mod.init(params, ocfg)
    residual = (compression.init_residual(params) if args.compress_grads
                else None)
    start_step = 0

    if args.resume and args.ckpt_dir \
            and checkpoint.latest_step(args.ckpt_dir) is not None:
        restored, start_step, _ = checkpoint.restore(args.ckpt_dir,
                                                     (params, opt_state))
        _load_into((params, opt_state), restored)
        print(f"resumed from step {start_step}")

    step_fn = make_train_step(cfg, ocfg, settings)
    ds = data.SyntheticLM(cfg, args.batch, args.seq, seed=args.seed)

    losses = []
    pending_save = None
    t0 = time.time()
    step = start_step
    injected = False
    _sync(device)
    t_step = time.perf_counter()
    while step < args.steps:
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in ds.next_batch(step).items()}
        if step == args.inject_nan_at and not injected:   # fault injection
            injected = True         # once: the restore path must not re-hit
            with torch.no_grad():
                for p in model.parameters():
                    if p.ndim:
                        p.mul_(float("nan"))
        model, opt_state, residual, metrics = step_fn(
            model, opt_state, batch, residual)
        loss = float(metrics["loss"])
        finite = bool(metrics["finite"] > 0)
        now = time.perf_counter()
        if record is not None:
            record.setdefault("steps", []).append(
                {"step": step, "loss": loss,
                 "grad_norm": float(metrics["grad_norm"]),
                 "lr": float(metrics["lr"]), "finite": finite,
                 "seconds": now - t_step})
        t_step = now
        if not finite:
            print(f"step {step}: NON-FINITE loss/grad — restoring")
            if args.ckpt_dir \
                    and checkpoint.latest_step(args.ckpt_dir) is not None:
                restored, step, _ = checkpoint.restore(args.ckpt_dir,
                                                       (params, opt_state))
                _load_into((params, opt_state), restored)
                continue
            else:                   # cold restart
                model = params = opt_state = None
                model = build_model(cfg, args.seed, device, args.init)
                params = dict(model.named_parameters())
                opt_state = opt_mod.init(params, ocfg)
                continue
        losses.append(loss)
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):8.3f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({(time.time()-t0):.1f}s)")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            if pending_save is not None:
                pending_save.join()
            pending_save = checkpoint.save_async(
                args.ckpt_dir, step + 1, (params, opt_state))
        step += 1
    if pending_save is not None:
        pending_save.join()
    if args.ckpt_dir:
        checkpoint.save(args.ckpt_dir, step, (params, opt_state))
    if record is not None:
        record.update(cfg=cfg, tokens_per_step=args.batch * (args.seq - 1),
                      state=(model, opt_state, step_fn, ds))
    print(f"final loss {np.mean(losses[-10:]):.4f} "
          f"(first-10 mean {np.mean(losses[:10]):.4f})")
    return losses


def gap(exp, twin) -> np.ndarray:
    """The reference's own spread on a run, step by step: the relative
    distance of its bfloat16 values ``exp`` from its float32 values
    ``twin`` (both in the reference's file).  Reported beside a bfloat16
    run; no bound is made of it."""
    exp, twin = np.asarray(exp, np.float64), np.asarray(twin, np.float64)
    return np.abs(exp - twin) / np.abs(exp)


def held(run: dict, key: str, got) -> np.ndarray:
    """Which steps of the port's values ``got`` of metric ``key`` hold
    against the reference's ``run`` (an entry of the reference file):
    each within :data:`TOLERANCE` relative, from step 1 within the run's
    own ``rtol`` where it gives one.  A run with ``weights`` has its
    gradient norm held on its trajectory at step 0 only, where both
    packages' weights are the same; from step 1 it is held on the
    reference's own weights instead (:func:`on_reference_weights`).  The
    run's ``why`` gives the measured reason of each departure."""
    got, exp = np.asarray(got, np.float64), np.asarray(run[key], np.float64)
    rtol = np.full(exp.shape, TOLERANCE[run["dtype"]][key])
    rtol[1:] = run.get("rtol", {}).get(key, rtol[1:])
    ok = np.abs(got - exp) <= rtol * np.abs(exp)
    if key == "grad_norm" and "weights" in run:
        ok[1:] = True
    return ok


def _leaves(tree, prefix: str = "") -> dict:
    """The leaves of a tree of dicts and lists, by dotted path."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _with_leaves(tree, leaves: dict, prefix: str = ""):
    """``tree`` with each leaf replaced by ``leaves`` at its path."""
    if isinstance(tree, dict):
        return {k: _with_leaves(v, leaves, f"{prefix}.{k}" if prefix
                                else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_with_leaves(v, leaves, f"{prefix}.{i}" if prefix
                             else str(i)) for i, v in enumerate(tree)]
    return leaves[prefix]


def save_weights(path, trees) -> None:
    """Write parameter trees (the reference's layout), one a step from
    step 1, as bfloat16 bit patterns: for a bfloat16 run that reads each
    weight only as bfloat16 (xlstm's smoke config does,
    ``tests/test_torch_families_train.py``) that rounding changes no loss
    or gradient."""
    out = {}
    for step, tree in enumerate(trees, 1):
        for name, a in _leaves(tree).items():
            t = torch.from_numpy(np.array(a, np.float32))
            out[f"{step}:{name}"] = t.to(torch.bfloat16).view(
                torch.int16).numpy().view(np.uint16)
    np.savez_compressed(path, **out)


def load_weights(path, cfg, seed: int, steps: int) -> list:
    """The trees of :func:`save_weights`, each step's leaves at float32,
    after :func:`convert.numpy_params` of ``seed`` for step 0."""
    template = convert.numpy_params(cfg, seed)
    trees = [template]
    with np.load(path) as store:
        for step in range(1, steps):
            trees.append(_with_leaves(template, {
                name: (store[f"{step}:{name}"].astype(np.uint32) << 16)
                .view(np.float32) for name in _leaves(template)}))
    return trees


def on_reference_weights(run: dict, ref: dict, device,
                         where=REFERENCE.parent) -> dict:
    """The port's loss and gradient norm at each step of ``run`` on the
    reference's own weights of that step (the run's ``weights`` file, in
    ``where``) and batch: each step's gradient alone, with no trajectory
    before it."""
    cfg = configs.get_smoke(run["arch"]).replace(dtype=DTYPES[run["dtype"]])
    ds = data.SyntheticLM(cfg, ref["batch"], ref["seq"], seed=ref["seed"])
    trees = load_weights(pathlib.Path(where) / run["weights"], cfg,
                         ref["seed"], ref["steps"])
    out = {"loss": [], "grad_norm": []}
    for step, tree in enumerate(trees):
        model = convert.from_reference(cfg, tree, device).requires_grad_()
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in ds.next_batch(step).items()}
        loss = api.loss(cfg, model, batch)
        loss.backward()
        out["loss"].append(float(loss.detach()))
        out["grad_norm"].append(float(opt_mod.global_norm(
            p.grad for p in model.parameters())))
    return out


def hold_against_reference(device, path=REFERENCE, archs=None,
                           dtypes=None) -> dict:
    """Run each committed reference training run's configuration (those of
    ``archs`` and ``dtypes`` where given) through :func:`main` on
    ``device`` (``--init numpy``, the same flags) and hold every step's
    loss, gradient norm and learning rate by :func:`held`; a run with
    ``weights`` also has its loss and gradient norm on the reference's
    own weights (:func:`on_reference_weights`) held at every step to
    :data:`TOLERANCE`.  Raises ``AssertionError`` on a mismatch; returns,
    by run, the largest relative error of each metric over the steps
    held; for a run with ``weights``, under ``"on_weights"`` those of its
    loss and gradient norm on the reference's weights and under
    ``"trajectory"`` its gradient norm's error at each step; for a
    bfloat16 run, under ``"gap"``, :func:`gap` at each step where the
    file has both types of the architecture's run."""
    ref = json.loads(pathlib.Path(path).read_text())
    f32 = {r["arch"]: r for r in ref["runs"] if r["dtype"] == "float32"}
    out = {}
    for run in ref["runs"]:
        if (archs is not None and run["arch"] not in archs) or \
                (dtypes is not None and run["dtype"] not in dtypes):
            continue
        rec = {}
        main(["--arch", run["arch"], "--smoke", "--steps", str(ref["steps"]),
              "--batch", str(ref["batch"]), "--seq", str(ref["seq"]),
              "--lr", str(ref["lr"]), "--seed", str(ref["seed"]),
              "--device", str(device), "--init", "numpy",
              "--dtype", run["dtype"], "--log-every", str(ref["steps"])],
             record=rec)
        name = f"{run['arch']} {run['dtype']}"
        twin = f32.get(run["arch"]) if run["dtype"] == "bfloat16" else None
        errs = {}
        for key in TOLERANCE[run["dtype"]]:
            got = np.array([r[key] for r in rec["steps"]])
            exp = np.array(run[key])
            if got.shape != exp.shape:
                raise AssertionError(f"{name}: {got.shape[0]} steps, the "
                                     f"reference {exp.shape[0]}")
            err = np.abs(got - exp) / np.abs(exp)
            ok = held(run, key, got)
            if not ok.all():
                raise AssertionError(
                    f"{name}: {key} {got.tolist()} against the reference's "
                    f"{exp.tolist()}: relative errors {err.tolist()}; steps "
                    f"{np.flatnonzero(~ok).tolist()} not held")
            if key == "grad_norm" and "weights" in run:
                errs["trajectory"] = err.tolist()
                err = err[:1]
            errs[key] = float(err.max())
        if "weights" in run:
            got = on_reference_weights(run, ref, device,
                                       pathlib.Path(path).parent)
            errs["on_weights"] = {}
            for key, vals in got.items():
                err = np.abs(np.array(vals) - run[key]) / np.abs(run[key])
                if not (err <= TOLERANCE[run["dtype"]][key]).all():
                    raise AssertionError(
                        f"{name}: {key} on the reference's own weights "
                        f"{vals} against the reference's {run[key]}: "
                        f"relative errors {err.tolist()}")
                errs["on_weights"][key] = float(err.max())
        if twin is not None:
            errs["gap"] = {k: gap(run[k], twin[k]).tolist()
                           for k in ("loss", "grad_norm")}
        out[name] = errs
    return out


if __name__ == "__main__":
    main()
