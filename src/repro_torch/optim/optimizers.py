"""In-house AdamW, the warmup-stable-decay schedule and gradient helpers.

A port of the reference's ``repro.optim.optimizers`` as plain functions on
dicts of tensors (parameter name -> tensor), run under ``torch.no_grad()``
in float32.  It is not ``torch.optim.AdamW``: the reference clips by the
global norm first, decays only tensors with ndim >= 2, and takes its lr
from ``wsd_schedule(step + 1)``.  Leaves are taken in sorted-name order,
the order in which the reference's tree flattens a dict, so
``global_norm`` sums in the same order.

``compress_grads`` casts gradients to bf16 before a cross-pod reduction;
the AdamW math still runs in float32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: Any = torch.float32    # bf16 = optimizer-state compression
    warmup_steps: int = 100
    total_steps: int = 10_000


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


@torch.no_grad()
def wsd_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Warmup-stable-decay schedule, in float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / _f32(max(cfg.warmup_steps, 1), step), max=1.0)
    decay_start = 0.8 * cfg.total_steps          # Python floats, as in the reference
    span = _f32(max(cfg.total_steps - decay_start, 1), step)
    frac = torch.clamp((step - _f32(decay_start, step)) / span, 0.0, 1.0)
    decay = 1.0 - _f32(0.9, step) * frac
    return _f32(cfg.learning_rate, step) * warm * decay


def _sorted(tree: Tree) -> Tree:
    return dict(sorted(tree.items()))


def adamw_init(params: Tree, cfg: OptimizerConfig) -> Dict[str, Any]:
    zeros = {k: torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)
             for k, p in _sorted(params).items()}
    dev = next(iter(zeros.values())).device if zeros else torch.device("cpu")
    return {
        "mu": zeros,
        "nu": {k: z.clone() for k, z in zeros.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


@torch.no_grad()
def global_norm(tree: Tree) -> torch.Tensor:
    total = None
    for leaf in _sorted(tree).values():
        s = torch.sum(torch.square(leaf.to(torch.float32)))
        total = s if total is None else total + s
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads: Tree, max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> Tuple[Tree, torch.Tensor]:
    """Scale ``grads`` to a global norm of at most ``max_norm``.  ``norm``
    is the caller's global norm where the tree is one rank's slices of a
    sharded one (its own leaves cannot give it); else ``global_norm``."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(_f32(max_norm, norm) / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, norm


def compress_grads(grads: Tree) -> Tree:
    """bf16 gradient compression for a cross-pod all-reduce."""
    return {k: g.to(torch.bfloat16) for k, g in grads.items()}


def decompress_grads(grads: Tree) -> Tree:
    return {k: g.to(torch.float32) for k, g in grads.items()}


@torch.no_grad()
def adamw_update(
    params: Tree,
    grads: Tree,
    state: Dict[str, Any],
    cfg: OptimizerConfig,
    norm: Optional[torch.Tensor] = None,
    ndim: Optional[Dict[str, int]] = None,
) -> Tuple[Tree, Dict[str, Any], torch.Tensor]:
    """Returns (new_params, new_state, grad_norm); the inputs are kept.
    ``norm``: the global norm of a sharded tree (``clip_by_global_norm``).
    ``ndim``: a leaf's rank in the reference's tree where it differs from
    the tensor's (a layer of a stacked leaf counts the stack's axis), which
    decides its weight decay."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, norm)
    step = state["step"] + 1
    lr = wsd_schedule(cfg, step)
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(_f32(cfg.beta1, stepf), stepf)
    bc2 = 1.0 - torch.pow(_f32(cfg.beta2, stepf), stepf)
    b1, b2 = cfg.beta1, cfg.beta2

    new_p, new_mu, new_nu = {}, {}, {}
    for k, p in _sorted(params).items():
        g32 = grads[k].to(torch.float32)
        mu32 = state["mu"][k].to(torch.float32) * b1 + (1 - b1) * g32
        nu32 = state["nu"][k].to(torch.float32) * b2 + (1 - b2) * torch.square(g32)
        del g32
        # mhat / (sqrt(nhat) + eps) in one expression: no float32 copy of the
        # leaf outlives its use (a 622 M-row embedding is 2.5 GB a copy)
        delta = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + cfg.eps)
        if (ndim or {}).get(k, p.dim()) >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        new_p[k] = (p.to(torch.float32) - lr * delta).to(p.dtype)
        del delta
        new_mu[k] = mu32.to(cfg.state_dtype)
        new_nu[k] = nu32.to(cfg.state_dtype)
    return new_p, {"mu": new_mu, "nu": new_nu, "step": step}, gnorm
