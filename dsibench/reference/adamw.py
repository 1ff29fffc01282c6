"""AdamW with global-norm clipping and a warmup-stable-decay schedule, as
the configurations state it, in float32.

* the gradients are scaled to a global norm of at most ``clip_norm``
  (the norm over every leaf, in float32) before the moments see them;
* step t's learning rate is ``learning_rate * min(t / warmup_steps, 1)``,
  times ``1 - 0.9 f`` where f runs from 0 to 1 over the last fifth of
  ``total_steps``;
* the moments are bias-corrected, and decoupled weight decay applies to
  the leaves in ``decayed`` (the configuration's rule).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable

import torch


def schedule(opt: Dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    start = 0.8 * opt["total_steps"]
    frac = min(max((step - start) / max(opt["total_steps"] - start, 1), 0.0), 1.0)
    return opt["learning_rate"] * warm * (1.0 - 0.9 * frac)


class AdamW:
    def __init__(self, opt: Dict, params: Dict[str, torch.Tensor], decayed: Iterable[str]):
        self.opt = opt
        self.decayed = set(decayed)
        self.mu = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def clip(self, grads: Dict[str, torch.Tensor]):
        """(the clipped gradients, the global norm before clipping)."""
        norm = math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in grads.values()))
        scale = min(self.opt["clip_norm"] / max(norm, 1e-9), 1.0)
        return {k: g * scale for k, g in grads.items()}, norm

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             store=lambda p: p) -> Dict[str, torch.Tensor]:
        """Update ``params`` in place (``store`` rounds a new value to the
        parameter's stored type); returns the clipped gradients."""
        o = self.opt
        g, _ = self.clip(grads)
        self.t += 1
        lr = schedule(o, self.t)
        bc1 = 1.0 - o["beta1"] ** self.t
        bc2 = 1.0 - o["beta2"] ** self.t
        for k, p in params.items():
            gk = g[k].float()
            self.mu[k].mul_(o["beta1"]).add_((1 - o["beta1"]) * gk)
            self.nu[k].mul_(o["beta2"]).add_((1 - o["beta2"]) * gk * gk)
            delta = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + o["eps"])
            if k in self.decayed:
                delta = delta + o["weight_decay"] * p
            p.copy_(store(p - lr * delta))
        return g
