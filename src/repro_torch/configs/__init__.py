"""Architecture configs of the port.

Each architecture module defines ``CONFIG`` (the exact public config) and
``SMOKE`` (a reduced same-family config for CPU tests), as the reference's
``repro.configs`` does.  Ported so far: ``dlrm-paper``, the dense
decoders ``qwen3-8b``, ``codeqwen1.5-7b``, ``qwen2-72b`` and
``llama3-405b``, the MLA + MoE ``deepseek-v2-236b``, the MoE
``kimi-k2-1t-a32b``, the vision LM ``llava-next-mistral-7b``, the pure
SSM ``mamba2-2.7b``, the hybrid ``jamba-1.5-large-398b`` and the
encoder-decoder ``seamless-m4t-large-v2``: every id of the reference's.
``SHAPES``, ``SMOKE_SHAPES`` and ``cell_supported`` are the reference's
assigned input shapes and the (arch, shape) cells they apply to.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Tuple

ARCH_IDS = [
    "mamba2-2.7b",
    "codeqwen1.5-7b",
    "llama3-405b",
    "qwen2-72b",
    "qwen3-8b",
    "jamba-1.5-large-398b",
    "llava-next-mistral-7b",
    "deepseek-v2-236b",
    "kimi-k2-1t-a32b",
    "seamless-m4t-large-v2",
    "dlrm-paper",
]

_MODULES = {
    "mamba2-2.7b": "mamba2_2p7b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "llama3-405b": "llama3_405b",
    "qwen2-72b": "qwen2_72b",
    "qwen3-8b": "qwen3_8b",
    "jamba-1.5-large-398b": "jamba15_large",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "seamless-m4t-large-v2": "seamless_m4t_v2",
    "dlrm-paper": "dlrm_paper",
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# Reduced shapes used by per-arch smoke tests (same modes, tiny extents).
SMOKE_SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 128, 2, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 128, 1, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 64, 2, "decode"),
    "long_500k": ShapeSpec("long_500k", 256, 1, "decode"),
}


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port has {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> Any:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> Any:
    return _module(arch).SMOKE


def cell_supported(arch: str, shape: str) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell applies, and why not where it does not."""
    cfg = get_config(arch)
    if arch == "dlrm-paper":
        if shape != "train_4k":
            return False, "DLRM has no sequence/KV-cache serving shapes"
        return True, ""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention architecture: 500k decode requires sub-quadratic attention"
    return True, ""
