"""Training runtime: DPP-fed DLRM training on one device.

The loop every trainer runs:
  batch = dpp_client.get_batch()   (data-stall accounted, Table 7 style)
  state = train_step(state, batch)

With an attached :class:`~repro_torch.train.embedding_cache.TieredEmbeddingStore`
the DLRM sparse path runs instead: embedding bags are served from the
hot/cold tier (``embed.fetch`` span), the step trains only the MLPs by
autograd and returns d(pooled), and the store applies the row-wise
AdaGrad scatter to the host tier — the MTrainS-style heterogeneous-memory
training loop.  Every step feeds ``StepMetrics`` into a ``MetricsRegistry``
(``train.*`` + ``embed.*``) so step time can be attributed across data
stall, embedding fetch, and compute.

A port of the reference's ``repro.train.trainer`` for one device.  The
model, the optimizer state and the step run on ``device`` (``cuda`` unless
the caller asks for the CPU); the store's tables and bookkeeping stay on
the host.  Not ported yet: checkpointing (``checkpoint_dir``,
``maybe_restore``) and the device mesh (``mesh``, ``rules``, ``remesh``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterable, Optional, Union

import numpy as np
import torch

from repro_torch.models import build_model
from repro_torch.obs import NULL_TRACER, MetricsRegistry, counter, gauge
from repro_torch.optim import OptimizerConfig, adamw_init, adamw_update, wsd_schedule


@dataclasses.dataclass
class TrainerConfig:
    log_every: int = 10
    max_steps: int = 200
    batch_timeout_s: float = 30.0
    tenant: str = ""            # tenant label on trainer spans (Table-7 rows)
    trace_stall: bool = True    # off when the batch source traces client.stall
    kernel_bags: bool = False   # serve fully-hot bags via the embedding_bag kernel


@dataclasses.dataclass
class StepMetrics:
    """Per-step point readings — gauges, not counters: each row is one
    step's level, never accumulated across steps by ``merge_metrics``."""

    step: int = gauge(merge="last")
    loss: float = gauge(0.0, merge="last")
    grad_norm: float = gauge(0.0, merge="last")
    step_time_s: float = gauge(0.0, merge="last")
    stall_s: float = gauge(0.0, merge="last")
    embed_fetch_s: float = gauge(0.0, merge="last")   # tiered-store lookup time
    hot_rate: float = gauge(0.0, merge="last")        # cumulative device-tier hit rate


@dataclasses.dataclass
class TrainMetrics:
    """Cumulative run totals the registry snapshots as ``train.*`` —
    counters accumulate across steps, loss/grad_norm report the level."""

    steps: int = counter()
    loss: float = gauge(0.0, merge="last")
    grad_norm: float = gauge(0.0, merge="last")
    step_s: float = counter(0.0)
    stall_s: float = counter(0.0)
    embed_fetch_s: float = counter(0.0)


class Trainer:
    def __init__(
        self,
        model_cfg: Any,
        opt_cfg: Optional[OptimizerConfig] = None,
        trainer_cfg: Optional[TrainerConfig] = None,
        tracer=NULL_TRACER,
        embedding_store: Optional[Any] = None,
        registry: Optional[MetricsRegistry] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.tracer = tracer
        self.model_cfg = model_cfg
        self.store = embedding_store
        # the tables live in the store's host tier on the sparse path, so
        # the model holds only the dense/interaction MLPs there
        self._sparse = embedding_store is not None
        self.model = build_model(model_cfg, tables=not self._sparse, device=device)
        self.device = self.model.device
        self.opt_cfg = opt_cfg or OptimizerConfig()
        self.cfg = trainer_cfg or TrainerConfig()
        self._train_step = self._sparse_step if self._sparse else self._dense_step
        self.history: list[StepMetrics] = []
        self.metrics = TrainMetrics()
        self.registry = registry or MetricsRegistry()
        self.registry.register("train", lambda: self.metrics)
        if self.store is not None:
            self.registry.register("embed", lambda: self.store.stats)

    # -- step ------------------------------------------------------------

    def _apply(self, params: Dict[str, torch.Tensor], grads, opt):
        new_p, opt, gnorm = adamw_update(
            {k: p.detach() for k, p in params.items()}, grads, opt, self.opt_cfg)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new_p[k])
        return opt, gnorm

    def _dense_step(self, opt, batch: Dict[str, torch.Tensor]):
        params = self.model.params()
        loss = self.model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        opt, gnorm = self._apply(params, dict(zip(params, grads)), opt)
        return opt, loss.detach(), gnorm

    def _sparse_step(self, opt, pooled: torch.Tensor, batch: Dict[str, torch.Tensor]):
        """MLP-only step for the tiered-embedding path: pooled bags come in
        as data, d(pooled) goes back out for the store's row-wise AdaGrad
        scatter, with the schedule lr the scatter must use."""
        params = self.model.params()
        pooled = pooled.detach().requires_grad_(True)
        loss = self.model.loss_from_pooled(pooled, batch)
        *grads, g_pooled = torch.autograd.grad(loss, [*params.values(), pooled])
        opt, gnorm = self._apply(params, dict(zip(params, grads)), opt)
        lr = wsd_schedule(self.opt_cfg, opt["step"])
        return opt, loss.detach(), gnorm, g_pooled, lr

    def init_state(self, seed: int = 0) -> Dict[str, Any]:
        """Fresh weights from ``seed`` and a zero optimizer state."""
        self.model.init_weights(seed)
        params = {k: p.detach() for k, p in self.model.params().items()}
        return {"params": params, "opt": adamw_init(params, self.opt_cfg), "step": 0}

    def load_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """Copy ``state["params"]`` into the model and move the optimizer
        state to the device; returns the state as the loop holds it."""
        params = self.model.params()
        if set(state["params"]) != set(params):
            raise ValueError(f"state params {sorted(state['params'])} != "
                             f"model params {sorted(params)}")
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(torch.as_tensor(state["params"][k]))
        dev = self.device
        opt = state["opt"]
        opt = {"mu": {k: v.to(dev) for k, v in opt["mu"].items()},
               "nu": {k: v.to(dev) for k, v in opt["nu"].items()},
               "step": torch.as_tensor(opt["step"], dtype=torch.int32).to(dev)}
        return {"params": {k: p.detach() for k, p in params.items()},
                "opt": opt, "step": int(state["step"])}

    # -- loop -----------------------------------------------------------------

    def _span_labels(self, step: int) -> Dict[str, Any]:
        if self.cfg.tenant:
            return {"step": step, "tenant": self.cfg.tenant}
        return {"step": step}

    def _to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device)

    def fit(
        self,
        batches: Iterable[Dict[str, np.ndarray]],
        state: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        state = self.load_state(state) if state is not None else self.init_state()
        opt, step = state["opt"], state["step"]

        it = iter(batches)
        while step < self.cfg.max_steps:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                break
            if batch is None:
                continue
            t1 = time.perf_counter()
            if self._sparse:
                ids = np.asarray(batch["sparse_ids"])
                smask = np.asarray(batch["sparse_mask"], np.float32)
                pooled = self.store.pooled(
                    ids, smask, use_kernel=self.cfg.kernel_bags
                )
                te = time.perf_counter()
                db = {"dense": self._to_device(batch["dense"]),
                      "label": self._to_device(batch["label"])}
                opt, loss, gnorm, dpooled, lr = self._train_step(
                    opt, self._to_device(pooled), db
                )
                self.store.apply_sparse_update(
                    dpooled.cpu().numpy(), ids, smask, lr=float(lr)
                )
            else:
                te = t1
                db = {k: self._to_device(v) for k, v in batch.items()}
                opt, loss, gnorm = self._train_step(opt, db)
            step += 1
            m = StepMetrics(step=step, loss=float(loss), grad_norm=float(gnorm))
            t2 = time.perf_counter()
            if self.tracer.enabled:
                if self.cfg.trace_stall and t1 > t0:
                    # batch-fetch wait: trainer-side stall (Table 7)
                    self.tracer.record(
                        "client.stall", t0, t1, **self._span_labels(step)
                    )
                if te > t1:
                    # tiered-embedding lookup: the embed-fetch share
                    self.tracer.record(
                        "embed.fetch", t1, te, **self._span_labels(step)
                    )
                self.tracer.record(
                    "train.step", te, t2, **self._span_labels(step)
                )
            m.step_time_s = t2 - te
            m.stall_s = t1 - t0
            m.embed_fetch_s = te - t1
            m.hot_rate = self.store.stats.hot_rate if self._sparse else 0.0
            self.history.append(m)
            self.metrics.steps += 1
            self.metrics.loss = m.loss
            self.metrics.grad_norm = m.grad_norm
            self.metrics.step_s += m.step_time_s
            self.metrics.stall_s += m.stall_s
            self.metrics.embed_fetch_s += m.embed_fetch_s
        params = {k: p.detach() for k, p in self.model.params().items()}
        return {"params": params, "opt": opt, "step": step}

    # -- reporting ----------------------------------------------------------------

    def stall_fraction(self) -> float:
        tot = sum(
            m.step_time_s + m.embed_fetch_s + m.stall_s for m in self.history
        )
        stall = sum(m.stall_s for m in self.history)
        return stall / tot if tot else 0.0

    def embed_fetch_fraction(self) -> float:
        tot = sum(
            m.step_time_s + m.embed_fetch_s + m.stall_s for m in self.history
        )
        emb = sum(m.embed_fetch_s for m in self.history)
        return emb / tot if tot else 0.0
