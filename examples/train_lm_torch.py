"""End-to-end training example on the PyTorch/CUDA port: a width-reduced
yi-9b variant on synthetic data, with checkpoints and fault tolerance.
The port's counterpart of ``examples/train_lm.py``, on the card unless
``--device cpu``; the checkpoints go to a temporary directory.

  PYTHONPATH=src python examples/train_lm_torch.py [--steps 300]
  PYTHONPATH=src python examples/train_lm_torch.py --steps 3 --device cpu
"""
import argparse
import tempfile

from repro_torch.launch import train as train_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="train_lm_torch_") as ck:
        return train_mod.main([
            "--arch", "yi-9b", "--smoke",
            "--steps", str(args.steps),
            "--batch", "8", "--seq", "64",
            "--lr", "3e-3",
            "--ckpt-dir", ck,
            "--ckpt-every", "100",
            "--log-every", "20",
            "--device", args.device,
        ])


if __name__ == "__main__":
    main()
