"""The port's side of ``tests/test_torch_dlrm_sharded.py``: ``run_rank``
runs on every rank of a gloo group that ``repro_torch.distributed.spawn``
starts, on the CPU, and returns numpy results.  It imports no JAX: the
ranks start fast."""
import dataclasses
import os
import shutil

import numpy as np
import torch

from repro_torch import configs
from repro_torch.convert import dlrm_shard_from_numpy
from repro_torch.distributed.sharding import TRAIN_RULES
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_dlrm_sparse_train_step
from repro_torch.models.dlrm import DLRM
from repro_torch.optim import OptimizerConfig
from repro_torch.train import Trainer, TrainerConfig

AXES = ("data", "model")


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy() if isinstance(tree, torch.Tensor) else tree


def _trainer_out(trainer, state):
    return {"loss": np.array([h.loss for h in trainer.history]),
            "grad_norm": np.array([h.grad_norm for h in trainer.history]),
            "params": _np(state["params"]),
            "mu": _np(state["opt"]["mu"]), "nu": _np(state["opt"]["nu"]),
            "step": int(state["step"])}


def run_rank(rank, shape, next_shape, ins, consts, dense0, sparse0, ckpt_dir):
    torch.set_num_threads(1)
    smoke = configs.get_smoke_config("dlrm-paper")
    cfg = dataclasses.replace(smoke, vocab_per_table=consts["vocab"])
    opt_cfg = OptimizerConfig(**consts["opt"])
    steps, batches = consts["steps"], ins["batches"]
    mesh = make_mesh(shape, AXES, device="cpu")
    out = {"coord": (mesh.coord("data"), mesh.coord("model"))}

    for tag, v in (("ops", consts["vocab"]), ("odd", consts["vocab_odd"]),
                   ("edge", consts["vocab"])):
        model = DLRM(dataclasses.replace(smoke, vocab_per_table=v), tables=False,
                     device="cpu")
        x = {k: torch.from_numpy(a) for k, a in ins[tag].items()}
        lo, hi = model.vocab_rows(mesh)
        tables = x["tables"][:, lo:hi].contiguous()
        acc = x["acc"][:, lo:hi].contiguous()
        lr = torch.tensor(consts["lr"]) if tag == "edge" else consts["lr"]   # 0-d too
        tb, ac = model.sparse_table_update_sharded(tables, acc, x["dpooled"], x, lr, mesh)
        out[tag] = {"lo": lo, "pooled": _np(model.pooled_embeddings_sharded(tables, x, mesh)),
                    "tables": _np(tb), "acc": _np(ac),
                    "kept": bool(torch.equal(tables, x["tables"][:, lo:hi])
                                 and torch.equal(acc, x["acc"][:, lo:hi]))}

    # the sparse step, 3 steps
    bundle = make_dlrm_sparse_train_step(cfg, mesh, consts["batch"], TRAIN_RULES, opt_cfg,
                                         device="cpu")
    state = dlrm_shard_from_numpy(sparse0, mesh)
    params, opt = state["params"], state["opt"]
    tables_ptr = params["tables"].data_ptr()
    losses, norms = [], []
    for b in batches[:steps]:
        params, opt, metrics = bundle.fn(params, opt, bundle.shard_batch(b))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    out["step"] = {"loss": np.array(losses), "grad_norm": np.array(norms),
                   "params": _np(params), "acc": _np(opt["acc"]),
                   "in_place": params["tables"].data_ptr() == tables_ptr,
                   "specs": [repr(s) for s in bundle.in_specs[2].values()]}

    # the dense Trainer on the mesh, 3 steps; then remesh and 3 more
    trainer = Trainer(cfg, opt_cfg, TrainerConfig(max_steps=steps), mesh=mesh, device="cpu")
    state = trainer.fit(batches[:steps], dlrm_shard_from_numpy(dense0, mesh))
    out["trainer"] = _trainer_out(trainer, state)
    mesh2 = make_mesh(next_shape, AXES, device="cpu")
    state = trainer.remesh(mesh2, state)
    trainer.cfg.max_steps = 2 * steps
    trainer.history.clear()
    state = trainer.fit(batches[steps:2 * steps], state)
    out["remesh"] = _trainer_out(trainer, state)
    out["coord2"] = (mesh2.coord("data"), mesh2.coord("model"))

    # a step-3 checkpoint on this mesh, resumed on the next one
    trainer = Trainer(cfg, opt_cfg, TrainerConfig(max_steps=steps, checkpoint_dir=ckpt_dir,
                                                  checkpoint_every=steps),
                      mesh=mesh, device="cpu")
    trainer.fit(batches[:steps], dlrm_shard_from_numpy(dense0, mesh))
    resume_dir = ckpt_dir + "_resumed"
    if rank == 0:
        shutil.copytree(ckpt_dir, resume_dir)
    mesh.barrier()
    trainer = Trainer(cfg, opt_cfg, TrainerConfig(max_steps=2 * steps,
                                                  checkpoint_dir=resume_dir),
                      mesh=mesh2, device="cpu")
    state = trainer.fit(batches[steps:2 * steps], dlrm_shard_from_numpy(dense0, mesh2))
    out["resumed"] = _trainer_out(trainer, state)
    out["ckpt_steps"] = sorted(os.listdir(ckpt_dir))
    return out


def mesh_rank(rank):
    """The mesh's coordinates, groups and collectives on four ranks."""
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    torch.set_num_threads(1)
    out = {}
    mesh = make_host_mesh(2, device="cpu")
    out["shape"], out["coord"] = mesh.shape, (mesh.coord("data"), mesh.coord("model"))
    x = torch.tensor([float(rank), 10.0 * rank])
    out["sum_model"] = mesh.all_reduce(x, "model").numpy()
    out["sum_all"] = mesh.all_reduce(x, ("data", "model")).numpy()
    out["x_kept"] = x.numpy()
    out["gather_data"] = mesh.all_gather(x[None], "data").numpy()
    out["gather_all"] = mesh.all_gather(x[None], ("data", "model")).numpy()
    flat = make_mesh((4, 1), AXES, device="cpu")
    out["size1_sum"] = flat.all_reduce(x, "model").numpy()
    out["size1_gather"] = flat.all_gather(x[None], "model").numpy()
    for bad in (lambda: make_production_mesh(device="cpu"),
                lambda: make_mesh((2, 4), AXES, device="cpu")):
        try:
            bad()
        except ValueError as e:
            out.setdefault("refused", []).append(str(e))
    return out


def failing_rank(rank):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return rank


def hanging_rank(rank):
    import time

    time.sleep(600)
