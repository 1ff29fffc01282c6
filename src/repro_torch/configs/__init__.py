"""Architecture configs of the port.

Each architecture module defines ``CONFIG`` (the exact public config) and
``SMOKE`` (a reduced same-family config for CPU tests), as the reference's
``repro.configs`` does.  Ported so far: ``dlrm-paper``, the dense GQA
``qwen3-8b`` and the pure SSM ``mamba2-2.7b``.
"""
from __future__ import annotations

import importlib
from typing import Any

ARCH_IDS = ["qwen3-8b", "mamba2-2.7b", "dlrm-paper"]

_MODULES = {"qwen3-8b": "qwen3_8b", "mamba2-2.7b": "mamba2_2p7b", "dlrm-paper": "dlrm_paper"}


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port has {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> Any:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> Any:
    return _module(arch).SMOKE
