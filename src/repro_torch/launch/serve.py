"""Serving entry point: prefill a batch of prompts, then batched decode with a
KV cache (or, for an SSM, its recurrent state).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --smoke \\
      --batch 4 --prompt-len 32 --decode-steps 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b --smoke \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 \\
      --smoke --device cpu

A port of the reference's ``repro.launch.serve``: the same flags and
printed lines, plus ``--device`` (``cuda`` unless asked for ``cpu``).
The weights are drawn from seed 0 on the device and the prompt from
``numpy.random.default_rng(0)`` in the reference's order (``make_prompt``);
the decode loop runs against a fresh fixed-capacity cache from position
0, as the reference's does (so an encoder-decoder's cross-attention there
reads a zero ``cross_k``/``cross_v``).  Every LM arch of
``repro_torch.configs`` is served: the decoder families (dense, GQA, MLA,
MoE, vision), the pure SSM, the hybrid and the encoder-decoder.  A vision
prompt needs at least ``num_patches`` positions.
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


def make_prompt(cfg, batch: int, prompt_len: int,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """The prompt ``serve`` prefills, drawn from ``default_rng(0)`` in the
    reference's order: tokens (B, prompt_len); for the vision frontend
    ``image_embeds`` normal(0, 0.02) of (B, num_patches, d_model); for the
    audio frontend ``frames`` normal(0, 0.02) of (B, prompt_len, d_model)
    and then the decoder's tokens (B, max(prompt_len // 8, 8)) in place of
    the first.  Embeddings in the compute dtype."""
    rng = np.random.default_rng(0)

    def tokens(shape):
        return torch.from_numpy(rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
                                ).to(device)

    def normal(shape):
        return torch.from_numpy(rng.normal(0, 0.02, shape)).to(device, cfg.compute_dtype)

    prompt = {"tokens": tokens((batch, prompt_len))}
    if cfg.frontend == "vision":
        prompt["image_embeds"] = normal((batch, cfg.num_patches, cfg.d_model))
    if cfg.frontend == "audio":
        prompt["frames"] = normal((batch, prompt_len, cfg.d_model))
        prompt["tokens"] = tokens((batch, max(prompt_len // 8, 8)))
    return prompt


def serve(model: DecoderLM, *, batch: int = 4, prompt_len: int = 32,
          decode_steps: int = 16, cache_len: int = 128) -> Dict[str, Any]:
    """Prefill ``batch`` prompts of ``prompt_len`` tokens (``make_prompt``;
    for the audio frontend ``prompt_len`` frames and a decoder prompt of
    ``max(prompt_len // 8, 8)`` tokens), then decode ``decode_steps``
    tokens greedily, on the model's device (any LM of the port: a
    ``DecoderLM`` or one of its subclasses); returns the timings, the
    sampled tokens (B, 1 + decode_steps) and the last logits."""
    dev = model.device
    prompt = make_prompt(model.cfg, batch, prompt_len, dev)

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
