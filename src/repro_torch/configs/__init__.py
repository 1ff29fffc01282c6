"""Architecture configs of the port.

Each architecture module defines ``CONFIG`` (the exact public config) and
``SMOKE`` (a reduced same-family config for CPU tests), as the reference's
``repro.configs`` does.  Ported so far: ``dlrm-paper``, the dense
decoders ``qwen3-8b``, ``codeqwen1.5-7b``, ``qwen2-72b`` and
``llama3-405b``, the MLA + MoE ``deepseek-v2-236b``, the MoE
``kimi-k2-1t-a32b``, the vision LM ``llava-next-mistral-7b``, the pure
SSM ``mamba2-2.7b``, the hybrid ``jamba-1.5-large-398b`` and the
encoder-decoder ``seamless-m4t-large-v2``: every id of the reference's.
"""
from __future__ import annotations

import importlib
from typing import Any

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


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port has {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> Any:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> Any:
    return _module(arch).SMOKE
