"""Serving entry point: prefill + batched greedy decode with
dynamic-wavefront request masking (the paper's TSC at request
granularity).

The port of ``repro/launch/serve.py``, with the same flags and the same
ragged ``stop_after`` mask, on the card by default:

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch granite-moe-3b-a800m --requests 8 --prompt-len 512 \
      --max-new 32 --max-len 1024

``--device cpu`` runs on the CPU (with the kernels' plain versions);
without it the run needs a CUDA device.  ``--init numpy`` takes the
weights of :func:`repro_torch.models.convert.numpy_params`, which a JAX
reference run can be given too; the default draws them on the device
from a ``torch.Generator``.  It prints prefill seconds, decode ms per
step and useful tokens per second.
"""
from __future__ import annotations

import argparse
import base64
import json
import pathlib
import time

import numpy as np
import torch

from .. import configs
from ..models import api, convert
from ..models.vlm import D_VIT
from ..training.steps import make_serve_decode_step

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_MODELS = pathlib.Path(__file__).resolve().parents[1] / "models"
#: the JAX reference's smoke serve (tokens and every step's logits),
#: written by ``tests/test_torch_serve.py --write``
REFERENCE = _MODELS / "reference_serve.json"
#: the same for zamba2, xlstm, seamless-m4t and internvl2, written by
#: ``tests/test_torch_serve_families.py --write``
REFERENCE_FAMILIES = _MODELS / "reference_serve_families.json"
#: activation type -> tolerance of a whole run's logits (or cache) against
#: the reference's: a ``share`` of the entries within ``atol + rtol * |ref|``
#: and every entry within ``bound``.  float32: all within its rounding.
#: bfloat16: rounding drift moves the residual stream by an ulp or two a
#: layer, and expert-choice routing then now and then moves one token
#: across an expert's capacity boundary, which moves that request's
#: logits by up to about 0.1 (tests/test_torch_models.py).
TOLERANCE = {
    "float32": {"atol": 2e-5, "rtol": 0.0, "share": 1.0, "bound": 2e-5},
    "bfloat16": {"atol": 3e-2, "rtol": 1 / 64, "share": 0.99, "bound": 0.25},
}


def tolerance_error(got: np.ndarray, exp: np.ndarray, dtype: str):
    """``None`` if ``got`` is within :data:`TOLERANCE` of ``exp``, else
    what is off."""
    t = TOLERANCE[dtype]
    err = np.abs(got - exp)
    share = float(np.mean(err <= t["atol"] + t["rtol"] * np.abs(exp)))
    if share < t["share"] or err.max() > t["bound"]:
        return (f"max abs err {err.max()} (bound {t['bound']}), "
                f"{share:.4f} within atol {t['atol']} + rtol {t['rtol']} "
                f"(need {t['share']})")
    return None


def greedy_mismatches(logits: np.ndarray, exp: np.ndarray, dtype: str):
    """``(differing, checked)``: greedy tokens of ``logits`` that differ
    from those of the reference logits ``exp``, counted where the
    reference's top-2 margin exceeds the type's ``atol``."""
    top2 = np.sort(exp, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > TOLERANCE[dtype]["atol"]
    return (int((logits.argmax(-1) != exp.argmax(-1))[clear].sum()),
            int(clear.sum()))


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on "
                           "the CPU")
    return dev


def float32_matmuls() -> None:
    """Keep the card's float32 products in float32 (TF32 off), for the
    whole process: the entry points that own the process call this."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build_model(cfg, seed: int, device, init: str = "torch"):
    """The serve's model: the reference's draws at ``cfg.param_dtype``,
    held at ``cfg.dtype`` only (serving keeps no float32 master copy)."""
    if init == "numpy":
        return convert.from_reference(cfg, convert.numpy_params(cfg, seed),
                                      device, keep_master=False)
    gen = torch.Generator(device=device).manual_seed(seed)
    return api.init_params(gen, cfg, device, keep_master=False)


def make_batch(cfg, seed: int, requests: int, prompt_len: int) -> dict:
    """The serve's inputs as numpy arrays, drawn from one numpy generator
    in the reference's order: the prompt tokens, then the frame
    embeddings of an ``encdec`` model (``prompt_len`` frames of width
    ``d_model``) or the patch embeddings of a ``vlm`` model
    (``num_patches`` of width ``D_VIT``), float32."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (requests, prompt_len))}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (requests, prompt_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (requests, cfg.num_patches, D_VIT)).astype(np.float32)
    return out


def make_prompt(cfg, seed: int, requests: int, prompt_len: int):
    """The serve's prompt tokens (those of :func:`make_batch`)."""
    return make_batch(cfg, seed, requests, prompt_len)["tokens"]


def make_inputs(cfg, seed: int, requests: int, prompt_len: int, device):
    """(prompt tokens, the other inputs) of :func:`make_batch` as tensors
    on ``device``."""
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in make_batch(cfg, seed, requests, prompt_len).items()}
    return batch.pop("tokens"), batch


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, model, prompt, max_new: int, max_len: int, *,
             inputs=None, force=None, keep_logits: bool = False) -> dict:
    """Prefill ``prompt`` (B, S), with ``inputs`` (``frames`` or
    ``patches``, as :func:`make_inputs` gives them) where the family
    takes them, and decode ``max_new`` greedy steps.

    ``force`` (B, max_new + 1): feed these tokens instead of the argmax
    (teacher forcing, to hold each step's logits against a reference run
    whose tokens differ by a near tie).  Returns the tokens (B,
    max_new + 1), each step's logits when ``keep_logits``, whether every
    step's logits were finite, the lengths the last decode step read, the
    prefill and decode seconds and the useful-token count.
    """
    device = prompt.device
    b = prompt.shape[0]
    _sync(device)
    t0 = time.perf_counter()
    logits, cache, lengths = api.prefill(
        cfg, model, {"tokens": prompt, **(inputs or {})}, max_len)
    _sync(device)
    prefill_s = time.perf_counter() - t0

    decode = make_serve_decode_step(cfg)
    # ragged stop times: request i finishes after 4 + i tokens (the
    # dynamic-wavefront mask: finished slots keep their lengths)
    stop_after = torch.from_numpy(np.minimum(4 + np.arange(b), max_new)
                                  .astype(np.int32)).to(device)
    out_tokens, out_logits = [], []

    def pick(step, lg):
        if keep_logits:
            out_logits.append(lg.float().cpu().numpy())
        tok = torch.argmax(lg, -1).to(torch.int32)
        out_tokens.append(tok)
        if force is not None:
            return torch.as_tensor(force[:, step], dtype=torch.int32,
                                   device=device)
        return tok

    finite = torch.isfinite(logits).all()
    tok = pick(0, logits)
    active = torch.ones((b,), dtype=torch.int32, device=device)
    last_lengths = lengths
    t0 = time.perf_counter()
    for step in range(max_new):
        last_lengths = lengths
        logits, cache, lengths = decode(model, cache, tok, lengths, active)
        finite &= torch.isfinite(logits).all()
        tok = pick(step + 1, logits)
        active = (step + 1 < stop_after).to(torch.int32)
    _sync(device)
    decode_s = time.perf_counter() - t0
    return {"tokens": torch.stack(out_tokens, 1).cpu().numpy(),
            "logits": np.stack(out_logits, 1) if keep_logits else None,
            "finite": bool(finite), "vocab": int(logits.shape[-1]),
            "last_lengths": last_lengths.cpu().numpy(),
            "prefill_s": prefill_s, "decode_s": decode_s,
            "useful": int(stop_after.sum())}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
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
    b = args.requests
    model = build_model(cfg, args.seed, device, args.init)
    prompt, inputs = make_inputs(cfg, args.seed, b, args.prompt_len, device)

    r = generate(cfg, model, prompt, args.max_new, args.max_len,
                 inputs=inputs)
    print(f"prefill: {b} x {args.prompt_len} in {r['prefill_s']:.3f}s")
    dt = r["decode_s"]
    print(f"decode: {args.max_new} steps x {b} reqs in {dt:.3f}s "
          f"({r['useful']} useful tokens, {1e3 * dt / args.max_new:.2f} "
          f"ms/step, {r['useful'] / dt:.1f} useful tokens/s)")
    print("sample continuation:", r["tokens"][0, :8].tolist())
    return r["tokens"]


def encode(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a, np.float32)
    return {"shape": list(a.shape),
            "float32_b64": base64.b64encode(a.tobytes()).decode()}


def decode_array(d: dict) -> np.ndarray:
    raw = base64.b64decode(d["float32_b64"])
    return np.frombuffer(raw, np.float32).reshape(d["shape"])


def hold_against_reference(device, path=REFERENCE) -> dict:
    """Run each committed reference serve's configuration on ``device``
    with its numpy weights and inputs, fed the reference's tokens, and
    hold every step's logits to :data:`TOLERANCE` and each greedy token
    to the reference's wherever its top-2 margin exceeds the type's
    ``atol``.  ``path``: a file of one architecture (``arch``) or of
    several (``archs``).  Raises ``AssertionError`` on a mismatch; returns
    per-type errors (by architecture for a file of several)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 is on: the float32 run would not compute "
                           "in float32 (call float32_matmuls first)")
    ref = json.loads(pathlib.Path(path).read_text())
    if "archs" not in ref:
        return _hold(device, ref["arch"], ref, ref["runs"], path)
    return {arch: _hold(device, arch, ref, runs, path)
            for arch, runs in ref["archs"].items()}


def _hold(device, arch: str, ref: dict, runs: dict, path) -> dict:
    out = {}
    for name, run in runs.items():
        cfg = configs.get_smoke(arch).replace(dtype=DTYPES[name])
        model = build_model(cfg, ref["seed"], device, "numpy")
        prompt, inputs = make_inputs(cfg, ref["seed"], ref["requests"],
                                     ref["prompt_len"], device)
        tokens = np.asarray(run["tokens"])
        r = generate(cfg, model, prompt, ref["max_new"], ref["max_len"],
                     inputs=inputs, force=tokens, keep_logits=True)
        exp, got = decode_array(run["logits"]), r["logits"]
        off = tolerance_error(got, exp, name)
        if off:
            raise AssertionError(f"{arch} {name} serve: logits off the "
                                 f"reference: {off}")
        if not np.array_equal(exp.argmax(-1), tokens):
            raise AssertionError(f"{path}: {arch}'s tokens are not the "
                                 "logits' argmax")
        bad, checked = greedy_mismatches(got, exp, name)
        if bad:
            raise AssertionError(f"{arch} {name} serve: {bad} of {checked} "
                                 "greedy tokens differ from the reference's")
        out[name] = {"max_abs_err": float(np.abs(got - exp).max()),
                     "tokens_checked": checked, "tokens": int(tokens.size)}
    return out


if __name__ == "__main__":
    main()
