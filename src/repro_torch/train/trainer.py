"""Training runtime: DPP-fed DLRM and LM training on one device.

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

Fault tolerance: with ``checkpoint_dir`` set, ``fit`` resumes from the
newest complete checkpoint (trainer crash) and saves ``{"params", "opt"}``
every ``checkpoint_every`` steps and at the end, in the reference's
layout and bytes (``repro_torch.checkpoint``), so a checkpoint crosses
between the packages.  On the sparse path that is the MLPs and their
AdamW state: the store's host tables are not saved, as in the reference.

A port of the reference's ``repro.train.trainer``.  The model, the
optimizer state and the step run on ``device`` (``cuda`` unless the
caller asks for the CPU); the store's tables and bookkeeping stay on the
host.

An LM config (``models.DecoderLM``, and the SSM, hybrid and
encoder-decoder models built on it) trains by the same dense step,
``model.loss`` differentiated by autograd and the reference's AdamW, on
one device; its parameters are the model's by name
(``layers.{i}.attn.wq``, ...).  Its checkpoint holds the reference's
tree: each stack of ``convert.LM_STACKS`` stacked on axis 0 again
(``convert.stack_layers``), for the parameters and for ``mu``/``nu``,
so an LM checkpoint crosses between the packages as the DLRM one does.

On a mesh (``mesh``, a ``launch.mesh.Mesh``; dense path only) every rank
runs the loop.  An LM takes the train step of ``launch.steps.make_train_step``
(built for each global batch size the loop sees): the rank holds its
slice of each parameter and of its AdamW moments by the rules' specs
(the reference's layout, which ``init_state`` draws and slices and
``remesh`` re-slices), gathers the leaves for its forward and, for an
expert-parallel MoE, keeps its slice of the experts.  A DLRM rank holds
its vocab slice of the tables
(``models.dlrm.vocab_rows``) and of their AdamW moments, the MLPs whole,
and its rows of each batch (split over the axes ``rules`` maps "batch"
to).  The pooled bags come from ``DLRM.pooled_embeddings_sharded``, whose
sum over "model" passes gradients through unchanged; the gradients are
averaged over the batch axes, and the global-norm clip adds the tables'
squares over "model" once and the replicated MLPs' once.  This is the
reference's layout for its sparse step (``shard_map`` over the vocab);
its ``TRAIN_RULES`` parameter layout (tables over "model" by table where
that divides, MLPs FSDP over "data") is a layout XLA reshards around,
and the port does not keep it.  ``init_state`` draws the one-device
weights and slices them; ``load_state`` takes a rank's slices
(``convert.dlrm_shard_from_numpy``); ``remesh(new_mesh, state)`` gathers
the tables and moments and re-slices them for a new mesh over the same
ranks.  A checkpoint holds whole leaves in the reference's layout:
gathered and written by rank 0, and read by every rank, which keeps its
own slices, so it resumes on any mesh, on one device and in the reference.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, Iterable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import flatten, nest, stack_layers, unstack_layers
from repro_torch.device import resolve
from repro_torch.distributed.sharding import TRAIN_RULES, P, shard_index, shard_leaf
from repro_torch.launch.steps import (
    batch_axes,
    batch_shardings,
    gather_leaf,
    make_train_step,
    shard_batch,
)
from repro_torch.models import build_model
from repro_torch.models.dlrm import DLRM, DLRMConfig, vocab_rows
from repro_torch.obs import NULL_TRACER, MetricsRegistry, counter, gauge
from repro_torch.optim import OptimizerConfig, adamw_init, adamw_update, wsd_schedule


@dataclasses.dataclass
class TrainerConfig:
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
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
        mesh: Optional[Any] = None,
        rules=TRAIN_RULES,
    ):
        self.tracer = tracer
        self.model_cfg = model_cfg
        self.store = embedding_store
        # the tables live in the store's host tier on the sparse path, so
        # the model holds only the dense/interaction MLPs there; on a mesh
        # the trainer holds the rank's slice of them beside the model
        dlrm = isinstance(model_cfg, DLRMConfig)
        self._sparse = embedding_store is not None and dlrm
        self.mesh = mesh
        self.rules = rules
        self.opt_cfg = opt_cfg or OptimizerConfig()
        self._lm_mesh = mesh is not None and not dlrm
        if mesh is not None:
            if self._sparse:
                raise ValueError("Trainer(mesh=...) runs the dense path; the tiered "
                                 "store's step runs on one device")
            if resolve(device, "Trainer").type != mesh.device.type:
                raise ValueError(f"device {device} but the mesh's ranks are on {mesh.device}")
            device = mesh.device
        self.tables: Optional[torch.Tensor] = None
        self._slices: Dict[str, torch.Tensor] = {}
        self._ndim: Optional[Dict[str, int]] = None
        if self._lm_mesh:
            self._place_slices()
        else:
            kwargs = dict(tables=not self._sparse and mesh is None) if dlrm else {}
            self.model = build_model(model_cfg, device=device, **kwargs)
            if not dlrm:
                self._ndim = {k: len(s.shape) for k, s in self.model.init_order()}
            if mesh is not None:
                self._place_tables()
        self.device = device if self._lm_mesh else self.model.device
        self.cfg = trainer_cfg or TrainerConfig()
        self.ckpt = (
            CheckpointManager(self.cfg.checkpoint_dir)
            if self.cfg.checkpoint_dir
            else None
        )
        self._train_step = self._sparse_step if self._sparse else self._dense_step
        self.history: list[StepMetrics] = []
        self.metrics = TrainMetrics()
        self.registry = registry or MetricsRegistry()
        self.registry.register("train", lambda: self.metrics)
        if self.store is not None:
            self.registry.register("embed", lambda: self.store.stats)

    # -- step ------------------------------------------------------------

    def _apply(self, params: Dict[str, torch.Tensor], grads, opt, norm=None):
        new_p, opt, gnorm = adamw_update(
            {k: p.detach() for k, p in params.items()}, grads, opt, self.opt_cfg, norm,
            self._ndim)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new_p[k])
        return opt, gnorm

    def _dense_step(self, opt, batch: Dict[str, torch.Tensor]):
        params = self._live_params()
        loss = self.model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        opt, gnorm = self._apply(params, dict(zip(params, grads)), opt)
        return opt, loss.detach(), gnorm

    def _mesh_step(self, opt, batch: Dict[str, torch.Tensor], axes):
        """The dense step on this rank's slices and rows (module docstring)."""
        mesh = self.mesh
        params = self._live_params()
        pooled = self.model.pooled_embeddings_sharded(self.tables, batch, mesh)
        loss = self.model.loss_from_pooled(pooled, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        n = math.prod(mesh.shape[a] for a in axes)
        with torch.no_grad():
            grads = {k: mesh.all_reduce(g, axes) / n for k, g in zip(params, grads)}
            sq = {k: torch.sum(torch.square(g)) for k, g in grads.items()}
            if self.model._vocab_shards(mesh) > 1:
                sq["tables"] = mesh.all_reduce(sq["tables"], "model")
            norm = torch.sqrt(sum(sq[k] for k in sorted(sq)))
            loss = mesh.all_reduce(loss.detach(), axes) / n
        opt, gnorm = self._apply(params, grads, opt, norm)
        return opt, loss, gnorm

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

    def _place_tables(self) -> None:
        """A (T, rows, E) parameter for this rank's slice of the tables."""
        c = self.model_cfg
        lo, hi = vocab_rows(c.vocab_per_table, self.mesh)
        self.tables = torch.nn.Parameter(torch.empty(
            (c.num_tables, hi - lo, c.embed_dim), dtype=c.param_dtype, device=self.mesh.device))

    def _place_slices(self) -> None:
        """An LM's train step on the mesh (for batches of one row, until
        the loop sees others: the parameter layout does not depend on
        them) and this rank's slice of each parameter."""
        self._bundle = make_train_step(self.model_cfg, self.mesh, 1, 1, self.rules,
                                       self.opt_cfg, self.mesh.device)
        self.model, self._rows = self._bundle.model, 1
        dtypes = {k: p.dtype for k, p in self.model.named_parameters()}
        self._slices = {k: torch.empty(shape, dtype=dtypes[k], device=self.mesh.device)
                        for k, shape in self._bundle.slice_shapes().items()}

    def _lm_step(self, batch: Dict[str, Any]):
        """The LM train step for batches of ``batch``'s global rows."""
        rows = np.shape(batch["tokens"])[0]
        if rows != self._rows:
            seq = np.shape(batch["frames" if "frames" in batch else "tokens"])[1]
            self._bundle = make_train_step(self.model_cfg, self.mesh, rows, seq, self.rules,
                                           self.opt_cfg, self.mesh.device)
            self.model, self._rows = self._bundle.model, rows
        return self._bundle

    def _specs(self) -> Dict[str, P]:
        """The spec this rank holds each parameter by on its mesh."""
        if self._lm_mesh:
            return self._bundle.in_specs[0]
        vocab = P(None, "model") if self.model._vocab_shards(self.mesh) > 1 else P()
        return {k: vocab if k == "tables" else P() for k in self._live_params()}

    def _live_params(self) -> Dict[str, torch.Tensor]:
        """The parameters the step differentiates, by name in sorted order
        (on a mesh, the rank's table slice among them, or an LM's slices;
        an LM's are its named parameters)."""
        if self._lm_mesh:
            return self._slices
        if not isinstance(self.model, DLRM):
            return dict(sorted(self.model.named_parameters()))
        params = self.model.params()
        if self.tables is not None:
            params = dict(sorted({**params, "tables": self.tables}.items()))
        return params

    def _params(self) -> Dict[str, torch.Tensor]:
        return {k: p.detach() for k, p in self._live_params().items()}

    def init_state(self, seed: int = 0) -> Dict[str, Any]:
        """Fresh weights from ``seed`` and a zero optimizer state.  On a
        mesh: the one-device weights, sliced (a DLRM's drawn whole on the
        host; an LM's drawn leaf by leaf on the rank's device,
        ``StepBundle.init_params``)."""
        if self.mesh is None:
            if isinstance(self.model, DLRM):
                self.model.init_weights(seed)
            else:
                self.model.init(seed)
            params = self._params()
            return {"params": params, "opt": adamw_init(params, self.opt_cfg), "step": 0}
        if self._lm_mesh:
            self._slices = self._bundle.init_params(seed)
            params = self._params()
            return {"params": params, "opt": adamw_init(params, self.opt_cfg), "step": 0}
        full = DLRM(self.model_cfg, seed=seed, device="cpu").params()
        lo, hi = vocab_rows(self.model_cfg.vocab_per_table, self.mesh)
        params = {k: p.detach()[:, lo:hi] if k == "tables" else p.detach()
                  for k, p in full.items()}
        return self.load_state({"params": params, "opt": adamw_init(params, self.opt_cfg),
                                "step": 0})

    def load_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """Copy ``state["params"]`` into the model (on a mesh, the rank's
        slices) and move the optimizer state to the device; returns the
        state as the loop holds it."""
        params = self._live_params()
        if set(state["params"]) != set(params):
            raise ValueError(f"state params {sorted(state['params'])} != "
                             f"model params {sorted(params)}")
        with torch.no_grad():
            for k, p in params.items():
                src = torch.as_tensor(state["params"][k])
                if src.shape != p.shape:
                    raise ValueError(f"state param {k} {tuple(src.shape)} != "
                                     f"{tuple(p.shape)} on this rank")
                p.copy_(src)
        dev = self.device
        opt = state["opt"]
        opt = {"mu": {k: v.to(dev) for k, v in opt["mu"].items()},
               "nu": {k: v.to(dev) for k, v in opt["nu"].items()},
               "step": torch.as_tensor(opt["step"], dtype=torch.int32).to(dev)}
        return {"params": self._params(), "opt": opt, "step": int(state["step"])}

    # -- fault tolerance ---------------------------------------------------

    @staticmethod
    def checkpoint_tree(params: Dict[str, Any], opt: Dict[str, Any]) -> Dict[str, Any]:
        """The reference's checkpoint tree ``{"params", "opt"}`` of the
        port's flat state: the dotted names nested, nothing transposed; an
        LM's layers (``{stack}.{i}.*`` of ``LM_STACKS``) stacked on axis 0."""
        def tree(flat):
            return nest(stack_layers(flat))

        return {"params": tree(params),
                "opt": {"mu": tree(opt["mu"]), "nu": tree(opt["nu"]), "step": opt["step"]}}

    def maybe_restore(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """The newest complete checkpoint, loaded into the model and onto
        the device, if the directory holds one; else ``state``.  On a mesh
        every rank reads the whole tables and keeps its rows."""
        if self.ckpt and self.ckpt.latest_step() is not None:
            params, opt = state["params"], state["opt"]
            if self.mesh is not None:
                params, opt = self._whole(params, opt, shapes_only=True)
            meta = {k: v.to("meta") for k, v in params.items()}
            mu = {k: v.to("meta") for k, v in opt["mu"].items()}
            nu = {k: v.to("meta") for k, v in opt["nu"].items()}
            step, restored = self.ckpt.restore(
                self.checkpoint_tree(meta, {"mu": mu, "nu": nu, "step": opt["step"]}))
            opt = restored["opt"]
            params = unstack_layers(flatten(restored["params"]))
            opt = {"mu": unstack_layers(flatten(opt["mu"])),
                   "nu": unstack_layers(flatten(opt["nu"])), "step": opt["step"]}
            if self.mesh is not None:
                params, opt = self._slice(params, opt)
            return self.load_state({"params": params, "opt": opt, "step": step})
        return state

    def _save(self, step: int, opt: Dict[str, Any]) -> None:
        params = self._params()
        if self.mesh is None:
            self.ckpt.save(step, self.checkpoint_tree(params, opt))
            return
        params, opt = self._whole(params, opt)
        if dist.get_rank() == 0:
            self.ckpt.save(step, self.checkpoint_tree(params, opt))
        self.mesh.barrier()

    # -- the mesh ------------------------------------------------------------

    def _map_leaves(self, params, opt, fn):
        """(params, opt) with ``fn(leaf, its spec)`` applied to the
        parameters and their moments that the mesh splits."""
        specs = self._specs()

        def on(tree):
            return {k: fn(v, specs[k]) if len(specs[k]) else v for k, v in tree.items()}

        return on(params), {"mu": on(opt["mu"]), "nu": on(opt["nu"]), "step": opt["step"]}

    def _whole(self, params, opt, shapes_only: bool = False):
        """(params, opt) with the split leaves and their moments gathered
        whole (``shapes_only``: empty stand-ins of the whole shapes, for a
        checkpoint template)."""
        mesh = self.mesh

        def whole(t, spec):
            if shapes_only:
                shape = [d * shard_index(ax, mesh)[0] if i < len(spec) else d
                         for i, (d, ax) in enumerate(zip(t.shape, tuple(spec) + (None,) * t.dim()))]
                return torch.empty(shape, dtype=t.dtype, device="meta")
            return gather_leaf(t, spec, mesh)

        return self._map_leaves(params, opt, whole)

    def _slice(self, params, opt):
        """(params, opt) with whole leaves and moments cut to this rank's
        slices."""
        return self._map_leaves(params, opt,
                                lambda t, spec: shard_leaf(t, spec, self.mesh).contiguous())

    def remesh(self, new_mesh, state: Dict[str, Any]) -> Dict[str, Any]:
        """Elastic scaling: move to ``new_mesh`` (over the same ranks) and
        return ``state`` (as ``fit`` returns it) re-sliced for it; the
        split leaves and their moments are gathered over the old mesh first."""
        if self.mesh is None or new_mesh.device != self.device:
            raise ValueError("remesh moves a mesh trainer to another mesh of its ranks' devices")
        params, opt = self._whole(state["params"], state["opt"])
        self.mesh = new_mesh
        if self._lm_mesh:
            self._place_slices()
        else:
            self._place_tables()
        params, opt = self._slice(params, opt)
        return self.load_state({"params": params, "opt": opt, "step": state["step"]})

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
        state = self.maybe_restore(state)
        opt, step = state["opt"], state["step"]
        del state       # the loop holds the state it steps, not the first one too

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
            elif self._lm_mesh:
                te = t1
                bundle = self._lm_step(batch)
                _, opt, metrics = bundle.fn(self._slices, opt, bundle.shard_batch(batch))
                loss, gnorm = metrics["loss"], metrics["grad_norm"]
            elif self.mesh is not None:
                te = t1
                specs = batch_shardings(self.model, batch, self.rules, self.mesh)
                opt, loss, gnorm = self._mesh_step(
                    opt, shard_batch(batch, specs, self.mesh), batch_axes(specs))
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
            if self.ckpt and step % self.cfg.checkpoint_every == 0:
                self._save(step, opt)
        if self.ckpt:
            self._save(step, opt)
        return {"params": self._params(), "opt": opt, "step": step}

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
