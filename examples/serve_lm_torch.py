"""Serving example on the PyTorch/CUDA port: batched prefill + decode with
dynamic-wavefront request masking (ragged request lifetimes) on a
width-reduced qwen3-moe-30b-a3b.  The port's counterpart of
``examples/serve_lm.py``, on the card unless ``--device cpu``.

  PYTHONPATH=src python examples/serve_lm_torch.py
  PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""
import argparse

from repro_torch.launch import serve as serve_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return serve_mod.main([
        "--arch", "qwen3-moe-30b-a3b", "--smoke",
        "--requests", "8", "--prompt-len", "16",
        "--max-new", "24", "--max-len", "128",
        "--device", args.device,
    ])


if __name__ == "__main__":
    main()
