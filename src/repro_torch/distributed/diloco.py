"""DiLoCo-style pod-local training with periodic cross-pod outer sync.

A port of the reference's ``repro.distributed.diloco`` over trees of
tensors (nested dicts, a model's parameters by name, say).  Motivated
directly by the paper's §4.2: cross-region (cross-pod) bandwidth is
highly constrained while within-pod bandwidth is plentiful.  Each pod
runs H local AdamW steps on its own data shard; every H steps the pods
exchange only the parameter *delta* (optionally bf16-compressed —
gradient compression at the outer level) and apply a Nesterov-momentum
outer step.

Communication reduction vs per-step all-reduce over the pod axis:
``H x (32/16 if compressed)``.  ``mean_over_pods`` is the caller's: on a
``launch.mesh.Mesh``, ``lambda t: {k: mesh.all_reduce(v, "pod") /
mesh.shape["pod"] for k, v in t.items()}``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class DiLoCoConfig:
    inner_steps: int = 32            # H
    outer_lr: float = 0.7
    outer_momentum: float = 0.9
    compress_bf16: bool = True


def _map(fn: Callable, *trees: Any) -> Any:
    """``fn`` leaf by leaf over trees of the same keys."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


@torch.no_grad()
def outer_init(params: Any) -> Any:
    return {
        "anchor": _map(lambda p: p.to(torch.float32).clone(), params),
        "momentum": _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params),
    }


@torch.no_grad()
def outer_step(
    pod_params: Any,              # this pod's params after H inner steps
    outer_state: Any,
    cfg: DiLoCoConfig,
    mean_over_pods: Callable[[Any], Any],
) -> Tuple[Any, Any]:
    """Exchange deltas across pods and take the outer (Nesterov) step.

    ``mean_over_pods`` is the only cross-pod communication: the mean of
    the (optionally bf16) parameter delta over the pods.
    """
    anchor = outer_state["anchor"]
    delta = _map(lambda p, a: a - p.to(torch.float32), pod_params, anchor)  # outer "gradient"
    if cfg.compress_bf16:
        delta = _map(lambda d: d.to(torch.bfloat16), delta)
    delta = mean_over_pods(delta)
    delta = _map(lambda d: d.to(torch.float32), delta)

    new_m = _map(lambda m, d: cfg.outer_momentum * m + d, outer_state["momentum"], delta)
    step_dir = _map(lambda m, d: cfg.outer_momentum * m + d, new_m, delta)  # Nesterov
    new_anchor = _map(lambda a, s: a - cfg.outer_lr * s, anchor, step_dir)
    new_params = _map(lambda p, a: a.to(p.dtype), pod_params, new_anchor)
    return new_params, {"anchor": new_anchor, "momentum": new_m}


def comm_savings(cfg: DiLoCoConfig, param_bytes: int) -> dict:
    """Bytes over the pod axis, per step, with and without DiLoCo."""
    per_step_allreduce = 2 * param_bytes          # bf16 grads, ring 2x
    diloco_per_h = param_bytes * (0.5 if cfg.compress_bf16 else 1.0) * 2
    return {
        "baseline_bytes_per_step": per_step_allreduce,
        "diloco_bytes_per_step": diloco_per_h / cfg.inner_steps,
        "reduction_x": per_step_allreduce * cfg.inner_steps / diloco_per_h,
    }
