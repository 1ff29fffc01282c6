#!/usr/bin/env python3
"""Both routes of ``ssd_chunk_forward`` at the mamba2-2.7b serve shape on
random operands, in turns, on one GPU.

    PYTHONPATH=src python3 benchmarks/torch/ssd_routes.py [--batch 4] [--turns 3]

x (B, 1024, 80, 64), B and C (B, 1024, 1, 128) bf16 and dt (B, 1024, 80)
float32 drawn on the card from seed 0 (dt = 3 softplus(z), A = -exp(0.3 z)),
chunk 256: the shape ``models/ssm.py``'s mixer hands the kernel in a
prefill of 4 x 1024 tokens.  Checks each route's y and final state
against ``ref.ssd_scan`` within ``chip_smoke.py``'s ``SSD_TOL``, then
prints the device time of each route (CUDA events around calls queued
behind a sleep kernel: ``chip_smoke.py``'s ``_queued_ms``) in turns,
with the card's name and power limit.  ``chip_smoke.py`` times the same
routes at the operands a real prefill makes; this script needs no model
and takes seconds, for comparing kernel versions within one run.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ssd_routes.py: CUDA is not available")
    from chip_smoke import SSD_TOL, _queued_ms, _ssd_close
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_chunk as kssd

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s, h, p, g, n, chunk = args.batch, 1024, 80, 64, 1, 128, 256
    x = (torch.randn((b, s, h, p), generator=gen, device="cuda") * 0.5).bfloat16()
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device="cuda")) * 3
    a = -torch.exp(torch.randn(h, generator=gen, device="cuda") * 0.3)
    bm = (torch.randn((b, s, g, n), generator=gen, device="cuda") * 0.5).bfloat16()
    cm = (torch.randn((b, s, g, n), generator=gen, device="cuda") * 0.5).bfloat16()
    if kssd.route(x, bm, cm, chunk) != "sm90":
        raise RuntimeError("the serve-shape operands do not take the tensor-core route")
    routes = {"ssd_chunk_forward_sm90": kssd.ssd_chunk_forward_sm90,
              "ssd_chunk_forward": kssd.ssd_chunk_forward_fma}
    want_y, want_state = ref.ssd_scan(x, dt, a, bm, cm)
    shares = {}
    for name, fn in routes.items():
        y, state = fn(x, dt, a, bm, cm, chunk=chunk)
        torch.cuda.synchronize()
        shares[name] = (_ssd_close(y, want_y, SSD_TOL["bfloat16"])[1],
                        _ssd_close(state, want_state, SSD_TOL["float32"])[1])
        if max(shares[name]) > 1:
            raise RuntimeError(f"{name}: shares of the bound {shares[name]}")
    turns = {name: [] for name in routes}
    for _ in range(args.turns):
        for name, fn in routes.items():
            turns[name].append(_queued_ms(torch, lambda fn=fn: fn(x, dt, a, bm, cm,
                                                                   chunk=chunk),
                                          iters=10) * 1e3)
    print(card)
    print(json.dumps({"shape": [b, s, h, p, g, n, chunk], "shares_y_state": shares,
                      "turns_us": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
