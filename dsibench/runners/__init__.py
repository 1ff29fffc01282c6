"""The runners: each builds a cell's program state from the benchmark's
inputs, drives its first steps and warm-up in set-up, runs the window and
hands what it produced to its plain reference."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

OPTIMIZER_KEYS = ("learning_rate", "beta1", "beta2", "eps", "weight_decay", "clip_norm",
                  "warmup_steps", "total_steps")


def program_config(config: Dict[str, Any]):
    """The program's config: its registered config of ``config["program"]``
    with every size of ``config["model"]`` (lists as tuples, dtype names
    as torch dtypes)."""
    from repro_torch import configs

    base = configs.get_config(config["program"])
    fields = {f.name for f in dataclasses.fields(base)}
    sizes = {k: (tuple(v) if isinstance(v, list) else
                 getattr(torch, v) if k.endswith("_dtype") else v)
             for k, v in config["model"].items() if k in fields}
    return dataclasses.replace(base, **sizes)


def optimizer_config(config: Dict[str, Any]):
    """The program's ``OptimizerConfig`` of ``config["optimizer"]``."""
    from repro_torch.optim import OptimizerConfig

    return OptimizerConfig(**{k: config["optimizer"][k] for k in OPTIMIZER_KEYS})
