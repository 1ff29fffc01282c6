"""Step builders for the port: the DLRM sparse train step on a mesh.

A port of the reference's ``repro.launch.steps`` for DLRM
(``_make_dlrm_sparse_train_step``, ``_INPUT_LOGICAL``,
``batch_shardings``); the generic LM builders come with LM training.

The reference builds one jitted program over the whole mesh; here every
rank runs ``StepBundle.fn`` on its own slices and calls the collectives
itself:

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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.convert import dlrm_tables_for_mesh
from repro_torch.device import resolve
from repro_torch.distributed.sharding import (
    TRAIN_RULES,
    AxisRules,
    P,
    logical_to_spec,
    shard_leaf,
)
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.optim import OptimizerConfig, adamw_init, adamw_update, wsd_schedule

_INPUT_LOGICAL = {
    "dense": ("batch", None),
    "sparse_ids": ("batch", None, None),
    "sparse_mask": ("batch", None, None),
    "label": ("batch",),
}


def dlrm_input_shapes(cfg: DLRMConfig, batch: int) -> Dict[str, Tuple[int, ...]]:
    """The shapes of a DLRM training batch of ``batch`` rows."""
    ids = (batch, cfg.num_tables, cfg.max_ids_per_feature)
    return {"dense": (batch, cfg.num_dense), "sparse_ids": ids, "sparse_mask": ids,
            "label": (batch,)}


def batch_shardings(shapes: Dict[str, Tuple[int, ...]], rules: AxisRules, mesh) -> Dict[str, P]:
    """The PartitionSpec of each input of these shapes."""
    return {k: logical_to_spec(_INPUT_LOGICAL[k], rules, mesh, v) for k, v in shapes.items()}


def batch_axes(specs: Dict[str, P]) -> Tuple[str, ...]:
    """The mesh axes the batch rows are split over under ``specs``."""
    first = specs["sparse_ids"][0] if len(specs["sparse_ids"]) else None
    if first is None:
        return ()
    return (first,) if isinstance(first, str) else tuple(first)


def shard_batch(batch: Dict[str, Any], specs: Dict[str, P], mesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch (numpy arrays or tensors) under
    ``specs``, on the mesh's device."""
    return {k: torch.as_tensor(np.ascontiguousarray(shard_leaf(np.asarray(v), specs[k], mesh)))
            .to(mesh.device) for k, v in batch.items()}


@dataclasses.dataclass
class StepBundle:
    """``fn(params, opt_state, batch) -> (params, opt_state, metrics)`` on
    this rank's slices, the PartitionSpecs it holds its arguments by
    (``in_specs``: params, optimizer state, batch), and the arguments it
    updates in place (``donate_argnums``)."""

    fn: Callable
    in_specs: Tuple[Any, ...]
    model: DLRM
    mesh: Any
    opt_cfg: OptimizerConfig
    donate_argnums: Tuple[int, ...] = ()

    def shard_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """This rank's rows of a global batch (numpy or tensors), on the
        mesh's device."""
        return shard_batch(batch, self.in_specs[2], self.mesh)

    def init_state(self, seed: int = 0) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        """Fresh (params, opt_state) for this rank: the MLPs drawn from
        ``seed`` (``DLRM.init_weights``), the tables by
        ``convert.dlrm_tables_for_mesh``, a zero accumulator and AdamW
        state."""
        self.model.init_weights(seed)
        params = {k: p.detach().clone() for k, p in self.model.params().items()}
        tables = dlrm_tables_for_mesh(self.model.cfg, self.mesh, seed)
        opt = {"adam": adamw_init(params, self.opt_cfg),
               "acc": torch.zeros(tables.shape[:2], dtype=torch.float32,
                                  device=tables.device)}
        params["tables"] = tables
        return dict(sorted(params.items())), opt


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
    dev = resolve(device, "make_dlrm_sparse_train_step")
    if dev.type != mesh.device.type:
        raise ValueError(f"device {dev} but the mesh's ranks are on {mesh.device}")
    model = DLRM(cfg, tables=False, device=mesh.device)
    bspecs = batch_shardings(dlrm_input_shapes(cfg, batch), rules, mesh)
    axes = batch_axes(bspecs)
    n_split = math.prod(mesh.shape[a] for a in axes)
    names = sorted(model.params())

    def train_step(params, opt_state, step_batch):
        tables = params["tables"]
        with torch.no_grad():
            for k, p in model.params().items():
                p.copy_(params[k])
            pooled = model.pooled_embeddings_sharded(tables, step_batch, mesh)
        pooled.requires_grad_(True)
        mlp = model.params()
        loss = model.loss_from_pooled(pooled, step_batch)
        *grads, g_pooled = torch.autograd.grad(loss, [*mlp.values(), pooled])
        with torch.no_grad():
            g_mlp = {k: mesh.all_reduce(g, axes) / n_split for k, g in zip(mlp, grads)}
            new_mlp, new_adam, gnorm = adamw_update(
                {k: p.detach() for k, p in mlp.items()}, g_mlp, opt_state["adam"], opt_cfg)
            lr = wsd_schedule(opt_cfg, opt_state["adam"]["step"] + 1) * 10.0
            for k in names:
                params[k].copy_(new_mlp[k])
            global_batch = {k: mesh.all_gather(step_batch[k], axes)
                            for k in ("sparse_ids", "sparse_mask")}
            model.sparse_table_update_sharded_(
                tables, opt_state["acc"], mesh.all_gather(g_pooled / n_split, axes),
                global_batch, lr, mesh)
            loss = mesh.all_reduce(loss.detach(), axes) / n_split
        new_opt = {"adam": new_adam, "acc": opt_state["acc"]}
        return params, new_opt, {"loss": loss, "grad_norm": gnorm}

    vocab = P(None, "model") if model._vocab_shards(mesh) > 1 else P()
    mlp_specs = {k: P() for k in names}
    param_specs = dict(sorted({**mlp_specs, "tables": vocab}.items()))
    opt_specs = {"adam": {"mu": mlp_specs, "nu": mlp_specs, "step": P()}, "acc": vocab}
    return StepBundle(fn=train_step, in_specs=(param_specs, opt_specs, bspecs), model=model,
                      mesh=mesh, opt_cfg=opt_cfg, donate_argnums=(0, 1))
