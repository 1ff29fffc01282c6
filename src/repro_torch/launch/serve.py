"""Serving entry point: prefill a batch of prompts, then batched decode with a
KV cache (or, for an SSM, its recurrent state).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --smoke \\
      --batch 4 --prompt-len 32 --decode-steps 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b --smoke \\
      --device cpu

A port of the reference's ``repro.launch.serve``: the same flags and
printed lines, plus ``--device`` (``cuda`` unless asked for ``cpu``).
The weights are drawn from seed 0 on the device and the prompt from
``numpy.random.default_rng(0)``; the decode loop runs against a fresh
fixed-capacity cache from position 0, as the reference's does.  The dense
GQA family (``qwen3-8b``) and the pure SSM family (``mamba2-2.7b``) are
ported.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import configs as cfglib
from repro_torch.models import DecoderLM, build_model

LM_ARCHS = [a for a in cfglib.ARCH_IDS if a != "dlrm-paper"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(model: DecoderLM, *, batch: int = 4, prompt_len: int = 32,
          decode_steps: int = 16, cache_len: int = 128) -> Dict[str, Any]:
    """Prefill ``batch`` prompts of ``prompt_len`` tokens, then decode
    ``decode_steps`` tokens greedily, on the model's device (any LM of the
    port: a ``DecoderLM`` or its subclass ``SSMLM``); returns the
    timings, the sampled tokens (B, 1 + decode_steps) and the last
    logits."""
    dev = model.device
    rng = np.random.default_rng(0)
    prompt = {"tokens": torch.from_numpy(rng.integers(
        0, model.cfg.vocab_size, (batch, prompt_len)).astype(np.int32)).to(dev)}

    _sync(dev)
    t0 = time.perf_counter()
    logits, _ = model.prefill(prompt)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    # decode against a fresh fixed-capacity cache (the serving layout)
    cache = model.init_cache(batch, cache_len)
    token = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
    toks = [token]
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(decode_steps):
        logits, cache = model.decode_step({"token": token, "pos": i, "cache": cache})
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(token)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return {
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_per_s": batch * decode_steps / t_decode if t_decode > 0 else 0.0,
        "tokens": torch.cat(toks, dim=1).cpu(),
        "logits": logits,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=LM_ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = cfglib.get_smoke_config(args.arch) if args.smoke else cfglib.get_config(args.arch)
    model = build_model(cfg, device=args.device).init(0)
    out = serve(model, batch=args.batch, prompt_len=args.prompt_len,
                decode_steps=args.decode_steps, cache_len=args.cache_len)
    print(f"arch={cfg.name} prefill_s={out['prefill_s']:.3f} "
          f"decode_tok_per_s={out['decode_tok_per_s']:.1f}")
    print("sampled tokens[0]:", out["tokens"][0, :16].tolist())
    ok = bool(torch.isfinite(out["logits"].float()).all())
    print("finite logits:", ok)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
