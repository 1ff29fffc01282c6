"""Serve a small LM on the PyTorch port with batched requests: prefill +
continuous decode, on ``--device`` (``cuda`` unless asked for ``cpu``).

  PYTHONPATH=src python examples/torch/serve_lm.py [--arch qwen3-8b] [--device cpu]
"""
import argparse

from repro_torch.launch import serve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return serve.main(["--arch", args.arch, "--smoke", "--batch", "8", "--prompt-len", "64",
                       "--decode-steps", "32", "--device", args.device])


if __name__ == "__main__":
    raise SystemExit(main())
