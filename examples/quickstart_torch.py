"""Quickstart on the PyTorch/CUDA port: assemble and run an eGPU program,
inspect cycles and the profile, then take one training step of a small
LM through the hand-written kernels' gradients.

  PYTHONPATH=src python examples/quickstart_torch.py            # the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The same program and checks as ``examples/quickstart.py`` (the JAX
reference's), on the card unless ``--device cpu``: FP and DOT/SUM steps
launch the eGPU kernels, the LM step the attention and expert-GEMM
kernels forward and backward (their plain versions on the CPU).
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (Asm, benchmark_config, machine, profile,
                              resources, run_program)
from repro_torch.launch.serve import resolve_device
from repro_torch.launch.train import build_model
from repro_torch.models import api
from repro_torch import configs
from repro_torch.training import data, optimizer
from repro_torch.training.steps import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    # 1. Configure an eGPU instance (static scalability: every knob is a
    #    configuration-time parameter, paper Tables 4-6).
    cfg = benchmark_config("dp", has_dot=True)   # 512 threads, 32 regs, 128KB
    print(f"eGPU: {cfg.max_threads} threads x {cfg.regs_per_thread} regs, "
          f"{cfg.shared_kb}KB shared, Fmax {cfg.fmax_mhz} MHz")
    r = resources(cfg)
    print(f"resources: {r.alms} ALMs, {r.dsps} DSPs, {r.m20ks} M20Ks "
          f"(normalized cost {r.normalized_cost})")

    # 2. A kernel in eGPU assembly: y[i] = a[i] * b[i] + a[i], then a SUM
    #    reduction written back with a 1-cycle MCU store (paper §3.1).
    a = Asm(cfg)
    a.tdx(1)                       # r1 = thread id
    a.lod(2, 1, 0)                 # r2 = a[i]        (shared[0:256])
    a.lod(3, 1, 256)               # r3 = b[i]        (shared[256:512])
    a.fmul(4, 2, 3)                # r4 = a*b
    a.fadd(4, 4, 2)                # r4 += a
    a.sto(4, 1, 512)               # y[i] = r4
    a.sum_(5, 4)                   # SP0.r5 = sum(y)  (dot-product unit)
    a.lodi(6, 768, tsc="mcu")
    a.sto(5, 6, 0, tsc="mcu")      # shared[768] = total, single-cycle write
    a.stop()
    img = a.assemble(threads_active=256)
    print(f"\nprogram: {img.n} instructions "
          f"(incl. auto-inserted hazard NOPs), IW={img.words[0]:011x}...")

    # 3. Load data, run on the device, verify.
    rng = np.random.default_rng(0)
    av = rng.standard_normal(256).astype(np.float32)
    bv = rng.standard_normal(256).astype(np.float32)
    st = run_program(img, shared_init=np.concatenate([av, bv]), tdx_dim=256,
                     device=dev)
    y = machine.shared_as_f32(st)[512:768]
    total = machine.shared_as_f32(st)[768]
    assert np.allclose(y, av * bv + av, atol=1e-5)
    assert np.isclose(total, (av * bv + av).sum(), rtol=1e-4)
    print(f"correct. cycles={int(st.cycles)} "
          f"({cfg.cycles_to_us(int(st.cycles)):.3f} us at {cfg.fmax_mhz} "
          f"MHz), hazard violations={int(st.hazard_violations)} ({dev})")
    print("profile:", {k: v for k, v in profile(st).items() if v[1]})

    # 4. One training step of granite-moe-3b-a800m's smoke config: the loss
    #    goes back through flash attention and the expert GEMMs.
    lm = configs.get_smoke("granite-moe-3b-a800m")
    model = build_model(lm, 0, dev)
    ocfg = optimizer.OptConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    opt = optimizer.init(dict(model.named_parameters()), ocfg)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             data.SyntheticLM(lm, 4, 16).next_batch(0).items()}
    step = make_train_step(lm, ocfg)
    model, opt, _, m = step(model, opt, batch, None)
    with torch.no_grad():
        after = float(api.loss(lm, model, batch))
    print(f"\nLM step ({lm.name} smoke): loss {float(m['loss']):.4f} -> "
          f"{after:.4f}, grad norm {float(m['grad_norm']):.3f}")
    assert np.isfinite(after) and float(m["finite"]) == 1.0
    return st


if __name__ == "__main__":
    main()
