"""Step builders for the port: any (arch config, shape, mesh) -> a step
that every rank of the mesh runs on its own slices.

A port of the reference's ``repro.launch.steps``: ``make_train_step``,
``make_prefill_step``, ``make_decode_step``, ``make_step``,
``_INPUT_LOGICAL``, ``batch_shardings`` and ``StepBundle``, with the DLRM
sparse train step (``make_dlrm_sparse_train_step``).

The reference builds one jitted program over the whole mesh and leaves
the collectives to XLA; here every rank runs ``StepBundle.fn`` on its own
slices and calls the collectives itself.  ``StepBundle.jit``/``lower``
and ``to_named`` (like ``distributed.sharding``'s ``named_sharding`` and
``with_logical``) have no torch meaning: there is no program to lower and
no ``NamedSharding`` to place a tree by.  ``in_specs`` holds the
PartitionSpecs a rank holds its arguments by, as the reference's
``in_shardings`` does, and ``donate_argnums`` the arguments it updates in
place.

The LM steps hold each parameter under its name in the model's state
dict (``layers.{i}.attn.wq``, ...; a stack's layers are leaves of their
own) by the spec ``partition_specs`` gives the reference's stacked leaf
under the rules, less the "stack" axis, which no rule shards:

* the rank gathers each leaf whole over the axes its spec shards it
  on, detached, and binds the gathered tensors into a model built on the
  ``meta`` device for the step; an expert leaf (first logical axis
  "expert") is gathered over every axis but "model" where the MoE is
  expert-parallel (``moe.expert_rows``), so the rank holds its slice of
  the experts and ``moe_forward_ep`` runs under ``sharding_context``;
* the train step runs ``model.loss`` on the rank's batch rows,
  differentiates it with respect to the gathered tensors (the expert
  region's gradients are summed over "model" by its own collectives,
  ``distributed.collectives``), averages the gradients over the batch
  axes, takes the global norm with each element counted once (the expert
  slices' squares summed over "model"), keeps its slice of each gradient
  and frees the rest, and takes the reference's AdamW step on its slices
  (``mu``/``nu`` held by the same specs), in place; the loss it returns is
  the mean over the batch axes.  On a data axis above 1 the reference's
  reported loss carries the first data shard's MoE aux loss, not their
  mean (its ``shard_map`` returns aux with spec ``P()`` unchecked), while
  its gradients are those of the mean, which is what the port reports;
* the prefill and decode steps run ``model.prefill`` / ``decode_step``
  on the rank's rows; the decode step gathers the cache over every axis
  but the batch's, writes the new row, and keeps its slice again.

The batch may not be split over "model" where the MoE is
expert-parallel: every "model" rank of an expert region must hold the
same tokens (the reference reshards them so; no config of the repo asks
for it).

The DLRM step is the reference's sharded sparse step:

* the tables are vocab-sharded over "model" (the reference's
  ``shard_map`` layout, ``P(None, "model", None)``), the MLPs and their
  AdamW state replicated, the batch split over the axes ``rules`` maps
  "batch" to ("data" on a ("data", "model") mesh);
* each rank pools its own rows' share of its batch rows, summed over
  "model" (``DLRM.pooled_embeddings_sharded``), and takes the MLP
  gradients and d(pooled) of its rows' mean loss;
* the MLP gradients are averaged over the batch axes before AdamW's
  global-norm clip, so every replica takes the same update;
* d(pooled) (divided by the data ranks, the gradient of the global mean
  loss), the ids and the masks are gathered over the batch axes, so every
  data replica of a table slice applies the whole batch's row-wise
  AdaGrad update (``sparse_table_update_sharded_``), at the reference's lr
  ``wsd_schedule(step + 1) * 10``;
* the tables, the accumulator and the MLP parameters are updated in place
  (the reference donates its state), so a full-vocab table is never held
  twice.

Tracing: ``StepBundle.attach_tracer`` installs a span ``Tracer``
(``NULL_TRACER`` until then; an LM's model gets it too, for its
attention spans).  ``shard_batch`` is a ``step.handoff`` span and adds
the bytes it hands to the device to ``metrics.handoff_bytes``; the DLRM
step's device work lies in three spans, in order: ``dlrm.pool`` (the
pooling), ``dlrm.dense`` (the MLPs' copy, forward and backward, their
gradients' all-reduce, AdamW, the lr and the loss's reduction) and
``dlrm.table_update`` (the all-gathers and the row-wise AdaGrad update).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Set, Tuple, Union

import numpy as np
import torch

from repro_torch import configs as cfglib
from repro_torch.convert import dlrm_tables_for_mesh, flatten
from repro_torch.device import resolve
from repro_torch.distributed.context import sharding_context
from repro_torch.distributed.sharding import (
    FSDP_RULES,
    SERVE_RULES,
    TRAIN_RULES,
    AxisRules,
    P,
    logical_to_spec,
    shard_index,
    shard_leaf,
)
from repro_torch.models import build_model
from repro_torch.models.common import init_leaf, partition_specs
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.models.moe import expert_rows
from repro_torch.obs import NULL_TRACER, counter
from repro_torch.optim import OptimizerConfig, adamw_init, adamw_update, wsd_schedule

_INPUT_LOGICAL = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "token": ("batch", None),
    "pos": (),
    "image_embeds": ("batch", None, None),
    "frames": ("batch", "seq", None),
    "dense": ("batch", None),
    "sparse_ids": ("batch", None, None),
    "sparse_mask": ("batch", None, None),
    "label": ("batch",),
}


def _shape(v: Any) -> Tuple[int, ...]:
    """The shape of an input given as a tensor or array, as a (shape,
    dtype) pair (``input_specs``) or as a shape."""
    if hasattr(v, "shape"):
        return tuple(v.shape)
    if len(v) == 2 and isinstance(v[0], tuple):
        return v[0]
    return tuple(v)


def _axes(ax: Any) -> Tuple[str, ...]:
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


def dlrm_input_shapes(cfg: DLRMConfig, batch: int) -> Dict[str, Tuple[int, ...]]:
    """The shapes of a DLRM training batch of ``batch`` rows."""
    ids = (batch, cfg.num_tables, cfg.max_ids_per_feature)
    return {"dense": (batch, cfg.num_dense), "sparse_ids": ids, "sparse_mask": ids,
            "label": (batch,)}


def batch_shardings(model, inputs: Dict[str, Any], rules: AxisRules, mesh) -> Dict[str, Any]:
    """The PartitionSpec of each input (tensors, arrays, ``input_specs``
    pairs or shapes); the cache's by ``model.cache_logical_axes()``."""
    out: Dict[str, Any] = {}
    for k, v in inputs.items():
        if k == "cache":
            logical = model.cache_logical_axes()
            out[k] = {ck: logical_to_spec(logical[ck], rules, mesh, _shape(cv))
                      for ck, cv in v.items()}
        else:
            out[k] = logical_to_spec(_INPUT_LOGICAL[k], rules, mesh, _shape(v))
    return out


def batch_axes(specs: Dict[str, Any]) -> Tuple[str, ...]:
    """The mesh axes the batch rows are split over under ``specs``."""
    for k in sorted(specs):
        if _INPUT_LOGICAL.get(k, ())[:1] == ("batch",):
            spec = specs[k]
            return _axes(spec[0] if len(spec) else None)
    return ()


def _shard_input(v: Any, spec: P, mesh) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return shard_leaf(v, spec, mesh).contiguous().to(mesh.device)
    return torch.as_tensor(np.ascontiguousarray(shard_leaf(np.asarray(v), spec, mesh))
                           ).to(mesh.device)


def shard_batch(batch: Dict[str, Any], specs: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's part of a global batch (numpy arrays or tensors; the
    cache a dict of them) under ``specs``, on the mesh's device."""
    return {k: ({ck: _shard_input(cv, specs[k][ck], mesh) for ck, cv in v.items()}
                if k == "cache" else _shard_input(v, specs[k], mesh))
            for k, v in batch.items()}


def gather_leaf(t: torch.Tensor, spec: P, mesh, skip: Tuple[int, ...] = ()) -> torch.Tensor:
    """``t``, this rank's slice along ``spec``, gathered whole over the
    spec's axes, but for the dimensions in ``skip``."""
    for dim, ax in enumerate(spec):
        if ax is not None and dim not in skip:
            t = mesh.all_gather(t, ax, dim=dim)
    return t


def slice_shape(shape: Tuple[int, ...], spec: P, mesh) -> Tuple[int, ...]:
    """The shape of a rank's slice of a leaf of ``shape`` along ``spec``."""
    out = list(shape)
    for dim, ax in enumerate(spec):
        out[dim] //= shard_index(ax, mesh)[0]
    return tuple(out)


@contextlib.contextmanager
def bound(model: torch.nn.Module, tensors: Dict[str, torch.Tensor]):
    """The model's parameters replaced by ``tensors`` (by name) for the
    block, and restored after it."""
    saved = []
    try:
        for name, t in tensors.items():
            mod_name, _, leaf = name.rpartition(".")
            mod = model.get_submodule(mod_name)
            saved.append((mod, leaf, mod._parameters[leaf]))
            mod._parameters[leaf] = t
        yield
    finally:
        for mod, leaf, p in reversed(saved):
            mod._parameters[leaf] = p


def _nbytes(tree: Dict[str, Any]) -> int:
    """The bytes of the tensors of a (possibly nested) batch."""
    n = 0
    for v in tree.values():
        n += _nbytes(v) if isinstance(v, dict) else v.nbytes
    return n


@dataclasses.dataclass
class BundleMetrics:
    """What a ``StepBundle`` has moved: the bytes of this rank's part of
    every batch ``shard_batch`` handed to the mesh's device."""

    handoff_bytes: int = counter()


@dataclasses.dataclass
class StepBundle:
    """``fn`` on this rank's slices: ``fn(params, opt_state, batch) ->
    (params, opt_state, metrics)`` for a train step, ``fn(params, batch)``
    for prefill and decode; the PartitionSpecs it holds its arguments by
    (``in_specs``), and the arguments it updates in place
    (``donate_argnums``).  ``expert`` names the leaves of which the rank
    holds its slice of the experts whole (an expert-parallel MoE).
    ``tracer`` records the spans of the hand-off and the step
    (``attach_tracer``), ``metrics`` the bytes handed off."""

    fn: Callable
    in_specs: Tuple[Any, ...]
    model: Any
    mesh: Any
    opt_cfg: Optional[OptimizerConfig] = None
    donate_argnums: Tuple[int, ...] = ()
    expert: Set[str] = dataclasses.field(default_factory=set)
    tracer: Any = NULL_TRACER
    metrics: BundleMetrics = dataclasses.field(default_factory=BundleMetrics)

    def attach_tracer(self, tracer) -> None:
        """Install a span ``Tracer`` (``NULL_TRACER`` to detach): the
        hand-off's and the step's spans, and an LM's attention spans."""
        self.tracer = tracer
        attach = getattr(self.model, "attach_tracer", None)
        if attach is not None:
            attach(tracer)

    def shard_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's part of a global batch, on the mesh's device (a
        ``step.handoff`` span; its bytes go to ``metrics.handoff_bytes``)."""
        with self.tracer.span("step.handoff"):
            out = shard_batch(batch, self.in_specs[-1], self.mesh)
            self.metrics.handoff_bytes += _nbytes(out)
        return out

    def shard_params(self, params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """This rank's slice of each whole leaf (by name), on its device."""
        return {k: _shard_input(v, self.in_specs[0][k], self.mesh)
                for k, v in sorted(params.items())}

    def slice_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """The shape of this rank's slice of each LM parameter."""
        return {k: slice_shape(tuple(self.model.get_parameter(k).shape), spec, self.mesh)
                for k, spec in self.in_specs[0].items()}

    def init_params(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        """This rank's slices of the LM weights ``model.init(seed)`` draws
        on the mesh's device type: each leaf drawn whole in ``init_order``,
        one at a time, and cut."""
        dev = self.mesh.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        out = {}
        for name, spec in self.model.init_order():
            full = torch.empty(self.model.get_parameter(name).shape, dtype=spec.dtype,
                               device=dev)
            init_leaf(full, spec, gen)
            part = shard_leaf(full, self.in_specs[0][name], self.mesh)
            out[name] = part if part is full else part.clone()
            del full, part
        return dict(sorted(out.items()))

    def init_state(self, seed: int = 0) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        """Fresh (params, opt_state) for this rank.  An LM: ``init_params``
        and a zero AdamW state.  DLRM: the MLPs drawn from ``seed``
        (``DLRM.init_weights``), the tables by
        ``convert.dlrm_tables_for_mesh``, a zero accumulator and AdamW
        state."""
        if not isinstance(self.model, DLRM):
            params = self.init_params(seed)
            return params, adamw_init(params, self.opt_cfg)
        self.model.init_weights(seed)
        params = {k: p.detach().clone() for k, p in self.model.params().items()}
        tables = dlrm_tables_for_mesh(self.model.cfg, self.mesh, seed)
        opt = {"adam": adamw_init(params, self.opt_cfg),
               "acc": torch.zeros(tables.shape[:2], dtype=torch.float32,
                                  device=tables.device)}
        params["tables"] = tables
        return dict(sorted(params.items())), opt


# ---------------------------------------------------------------------------
# The LM steps
# ---------------------------------------------------------------------------


def _check_device(device, mesh, who: str) -> None:
    dev = resolve(device, who)
    if dev.type != mesh.device.type:
        raise ValueError(f"device {dev} but the mesh's ranks are on {mesh.device}")


def _lm_layout(cfg, rules: AxisRules, mesh):
    """(the model on ``meta``, each parameter's spec by name, the expert
    leaves held as the rank's slice of the experts)."""
    model = build_model(cfg, device="meta")
    stacks = model.stacks()
    specs, expert = {}, set()
    ep = cfg.moe is not None and expert_rows(cfg.moe.num_experts, mesh) != (
        0, cfg.moe.num_experts)
    tree = flatten(partition_specs(model.stacked_param_specs(), rules, mesh))
    logical = flatten(model.stacked_param_specs())
    for name, spec in tree.items():
        axes = logical[name].logical
        key, _, rest = name.partition(".")
        names = [name]
        if key in stacks:
            if len(spec) and spec[0] is not None:
                raise ValueError(f"{name}: the rules shard the 'stack' axis ({spec}); the "
                                 "port holds a stack's layers as leaves of their own")
            spec, axes = P(*spec[1:]), axes[1:]
            names = [f"{key}.{i}.{rest}" for i in range(stacks[key])]
        if ep and axes[0] == "expert":
            if not len(spec) or spec[0] != "model":
                raise ValueError(f"{name}: an expert-parallel leaf must be split over "
                                 f"'model' on its expert axis, not {spec}")
            expert.update(names)
        for n in names:
            specs[n] = spec
    return model, dict(sorted(specs.items())), expert


def _gathered(params, specs, expert, mesh) -> Dict[str, torch.Tensor]:
    """Each leaf gathered whole, an expert leaf but for its expert axis."""
    return {k: gather_leaf(params[k], specs[k], mesh, (0,) if k in expert else ())
            for k in specs}


def _default_rules(cfg) -> AxisRules:
    return FSDP_RULES if getattr(cfg, "sharding_profile", "tp") == "fsdp" else TRAIN_RULES


def make_train_step(
    cfg: Any,
    mesh,
    batch: int,
    seq: int,
    rules: Optional[AxisRules] = None,
    opt_cfg: Optional[OptimizerConfig] = None,
    device: Union[str, torch.device] = "cuda",
) -> StepBundle:
    """The train step of ``cfg`` on ``mesh`` for global batches of
    ``batch`` rows of ``seq`` positions (module docstring); a
    ``DLRMConfig`` gets ``make_dlrm_sparse_train_step``.  ``device`` must
    be the mesh's device type."""
    if rules is None:
        rules = _default_rules(cfg)
    opt_cfg = opt_cfg or OptimizerConfig()
    if isinstance(cfg, DLRMConfig):
        return make_dlrm_sparse_train_step(cfg, mesh, batch, rules, opt_cfg, device)
    _check_device(device, mesh, "make_train_step")
    model, specs, expert = _lm_layout(cfg, rules, mesh)
    bspecs = batch_shardings(model, model.input_specs(batch, seq, "train"), rules, mesh)
    axes = batch_axes(bspecs)
    if expert and "model" in axes:
        raise ValueError(f"{cfg.name}: the batch is split over 'model' ({axes}), and an "
                         "expert-parallel MoE needs the same tokens on every 'model' rank")
    n_split = math.prod(mesh.shape[a] for a in axes)
    names = list(specs)
    ndim = {name: len(spec.shape) for name, spec in model.init_order()}

    def train_step(params, opt_state, step_batch):
        with torch.no_grad():
            full = {k: t.detach().requires_grad_(True)
                    for k, t in _gathered(params, specs, expert, mesh).items()}
        with bound(model, full), sharding_context(mesh, rules):
            loss = model.loss(step_batch)
            grads = torch.autograd.grad(loss, [full[k] for k in names], allow_unused=True)
        del full
        with torch.no_grad():
            sq_plain = torch.zeros((), dtype=torch.float32, device=mesh.device)
            sq_expert = torch.zeros((), dtype=torch.float32, device=mesh.device)
            g_slices = {}
            grads = list(grads)
            for i, k in enumerate(names):
                g = grads[i]
                grads[i] = None
                if g is None:                      # a leaf the loss does not read
                    shape = tuple(model.get_parameter(k).shape)
                    if k in expert:
                        shape = (params[k].shape[0],) + shape[1:]
                    g = torch.zeros(shape, dtype=params[k].dtype, device=mesh.device)
                if n_split > 1:
                    g = mesh.all_reduce(g, axes) / n_split
                s = torch.sum(torch.square(g.to(torch.float32)))
                if k in expert:
                    sq_expert += s
                else:
                    sq_plain += s
                spec = P(None, *specs[k][1:]) if k in expert else specs[k]
                part = shard_leaf(g, spec, mesh)
                g_slices[k] = part if part is g else part.clone()
                del g, part
            if expert:
                sq_plain = sq_plain + mesh.all_reduce(sq_expert, "model")
            norm = torch.sqrt(sq_plain)
            new_p, new_opt, gnorm = adamw_update({k: params[k] for k in names}, g_slices,
                                                 opt_state, opt_cfg, norm, ndim)
            del g_slices
            for k in names:
                params[k].copy_(new_p[k])
            del new_p
            loss = loss.detach()
            if n_split > 1:
                loss = mesh.all_reduce(loss, axes) / n_split
        return params, new_opt, {"loss": loss, "grad_norm": gnorm}

    opt_specs = {"mu": specs, "nu": specs, "step": P()}
    return StepBundle(fn=train_step, in_specs=(specs, opt_specs, bspecs), model=model,
                      mesh=mesh, opt_cfg=opt_cfg, donate_argnums=(0, 1), expert=expert)


def make_prefill_step(cfg: Any, mesh, batch: int, seq: int,
                      rules: Optional[AxisRules] = None,
                      device: Union[str, torch.device] = "cuda") -> StepBundle:
    """``model.prefill`` on this rank's rows: (last logits, cache) of its
    rows, the cache over the whole prompt."""
    rules = rules or SERVE_RULES
    _check_device(device, mesh, "make_prefill_step")
    model, specs, expert = _lm_layout(cfg, rules, mesh)
    bspecs = batch_shardings(model, model.input_specs(batch, seq, "prefill"), rules, mesh)

    @torch.no_grad()
    def prefill_step(params, step_batch):
        with bound(model, _gathered(params, specs, expert, mesh)), \
                sharding_context(mesh, rules):
            return model.prefill(step_batch)

    return StepBundle(fn=prefill_step, in_specs=(specs, bspecs), model=model, mesh=mesh,
                      expert=expert)


def make_decode_step(cfg: Any, mesh, batch: int, seq: int,
                     rules: Optional[AxisRules] = None,
                     device: Union[str, torch.device] = "cuda") -> StepBundle:
    """``model.decode_step`` on this rank's rows: their logits, and the
    cache slice it was given with the new row written, in place."""
    rules = rules or SERVE_RULES
    _check_device(device, mesh, "make_decode_step")
    model, specs, expert = _lm_layout(cfg, rules, mesh)
    bspecs = batch_shardings(model, model.input_specs(batch, seq, "decode"), rules, mesh)
    logical = model.cache_logical_axes()
    # the cache's specs but for the batch axis, whose rows the rank keeps
    beyond = {k: P(*(None if name == "batch" else ax
                     for name, ax in zip(logical[k], spec)))
              for k, spec in bspecs["cache"].items()}

    @torch.no_grad()
    def decode_step(params, step_batch):
        cache = step_batch["cache"]
        whole = {k: gather_leaf(t, beyond[k], mesh) for k, t in cache.items()}
        with bound(model, _gathered(params, specs, expert, mesh)), \
                sharding_context(mesh, rules):
            logits, whole = model.decode_step({**step_batch, "cache": whole})
        for k, t in cache.items():
            part = shard_leaf(whole[k], beyond[k], mesh)
            if part.data_ptr() != t.data_ptr():
                t.copy_(part)
        return logits, cache

    return StepBundle(fn=decode_step, in_specs=(specs, bspecs), model=model, mesh=mesh,
                      expert=expert)


def make_step(arch: str, shape_name: str, mesh, smoke: bool = False,
              rules: Optional[AxisRules] = None,
              device: Union[str, torch.device] = "cuda") -> StepBundle:
    """Uniform entry: (arch id, shape id) -> StepBundle."""
    cfg = cfglib.get_smoke_config(arch) if smoke else cfglib.get_config(arch)
    shape = (cfglib.SMOKE_SHAPES if smoke else cfglib.SHAPES)[shape_name]
    if shape.mode == "train":
        return make_train_step(cfg, mesh, shape.global_batch, shape.seq_len, rules,
                               device=device)
    if shape.mode == "prefill":
        return make_prefill_step(cfg, mesh, shape.global_batch, shape.seq_len, rules, device)
    return make_decode_step(cfg, mesh, shape.global_batch, shape.seq_len, rules, device)


# ---------------------------------------------------------------------------
# The DLRM sparse step
# ---------------------------------------------------------------------------


def make_dlrm_sparse_train_step(
    cfg: DLRMConfig,
    mesh,
    batch: int,
    rules: Optional[AxisRules] = None,
    opt_cfg: Optional[OptimizerConfig] = None,
    device: Union[str, torch.device] = "cuda",
) -> StepBundle:
    """DLRM sparse-path step: dense AdamW for the MLPs and row-wise AdaGrad
    scatter-updates for the vocab-sharded tables (see the module
    docstring).  ``device`` must be the mesh's device type."""
    rules = rules or TRAIN_RULES
    opt_cfg = opt_cfg or OptimizerConfig()
    _check_device(device, mesh, "make_dlrm_sparse_train_step")
    model = DLRM(cfg, tables=False, device=mesh.device)
    bspecs = batch_shardings(model, dlrm_input_shapes(cfg, batch), rules, mesh)
    axes = batch_axes(bspecs)
    n_split = math.prod(mesh.shape[a] for a in axes)
    names = sorted(model.params())

    def train_step(params, opt_state, step_batch):
        tracer = bundle.tracer
        tables = params["tables"]
        with tracer.span("dlrm.pool"), torch.no_grad():
            pooled = model.pooled_embeddings_sharded(tables, step_batch, mesh)
        with tracer.span("dlrm.dense"):
            with torch.no_grad():
                for k, p in model.params().items():
                    p.copy_(params[k])
            pooled.requires_grad_(True)
            mlp = model.params()
            loss = model.loss_from_pooled(pooled, step_batch)
            *grads, g_pooled = torch.autograd.grad(loss, [*mlp.values(), pooled])
            with torch.no_grad():
                g_mlp = {k: mesh.all_reduce(g, axes) / n_split for k, g in zip(mlp, grads)}
                new_mlp, new_adam, gnorm = adamw_update(
                    {k: p.detach() for k, p in mlp.items()}, g_mlp, opt_state["adam"],
                    opt_cfg)
                lr = wsd_schedule(opt_cfg, opt_state["adam"]["step"] + 1) * 10.0
                for k in names:
                    params[k].copy_(new_mlp[k])
                loss = mesh.all_reduce(loss.detach(), axes) / n_split
        with tracer.span("dlrm.table_update"), torch.no_grad():
            global_batch = {k: mesh.all_gather(step_batch[k], axes)
                            for k in ("sparse_ids", "sparse_mask")}
            model.sparse_table_update_sharded_(
                tables, opt_state["acc"], mesh.all_gather(g_pooled / n_split, axes),
                global_batch, lr, mesh)
        new_opt = {"adam": new_adam, "acc": opt_state["acc"]}
        return params, new_opt, {"loss": loss, "grad_norm": gnorm}

    vocab = P(None, "model") if model._vocab_shards(mesh) > 1 else P()
    mlp_specs = {k: P() for k in names}
    param_specs = dict(sorted({**mlp_specs, "tables": vocab}.items()))
    opt_specs = {"adam": {"mu": mlp_specs, "nu": mlp_specs, "step": P()}, "acc": vocab}
    bundle = StepBundle(fn=train_step, in_specs=(param_specs, opt_specs, bspecs), model=model,
                        mesh=mesh, opt_cfg=opt_cfg, donate_argnums=(0, 1))
    return bundle
