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
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    float32_matmuls()
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    if args.dtype:
        cfg = cfg.replace(dtype=DTYPES[args.dtype])
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


def hold_against_reference(device, path=REFERENCE) -> dict:
    """Run each committed reference training run's configuration through
    :func:`main` on ``device`` (``--init numpy``, the same flags) and hold
    every step's loss, gradient norm and learning rate to
    :data:`TOLERANCE`.  Raises ``AssertionError`` on a mismatch; returns
    the largest relative error of each metric by run."""
    ref = json.loads(pathlib.Path(path).read_text())
    out = {}
    for run in ref["runs"]:
        rec = {}
        main(["--arch", run["arch"], "--smoke", "--steps", str(ref["steps"]),
              "--batch", str(ref["batch"]), "--seq", str(ref["seq"]),
              "--lr", str(ref["lr"]), "--seed", str(ref["seed"]),
              "--device", str(device), "--init", "numpy",
              "--dtype", run["dtype"], "--log-every", str(ref["steps"])],
             record=rec)
        name = f"{run['arch']} {run['dtype']}"
        errs = {}
        for key, rtol in TOLERANCE[run["dtype"]].items():
            got = np.array([r[key] for r in rec["steps"]])
            exp = np.array(run[key])
            if got.shape != exp.shape:
                raise AssertionError(f"{name}: {got.shape[0]} steps, the "
                                     f"reference {exp.shape[0]}")
            err = np.abs(got - exp) / np.abs(exp)
            if not (err <= rtol).all():
                raise AssertionError(f"{name}: {key} {got.tolist()} against "
                                     f"the reference's {exp.tolist()}: "
                                     f"relative error {err.max()} beyond "
                                     f"{rtol}")
            errs[key] = float(err.max())
        out[name] = errs
    return out


if __name__ == "__main__":
    main()
