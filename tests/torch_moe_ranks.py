"""The port's side of ``tests/test_torch_moe.py``'s expert-parallel
tests: ``run_rank`` runs on every rank of a gloo group that
``repro_torch.distributed.spawn`` starts, on the CPU, and returns numpy
results.  It imports no JAX: the ranks start fast."""
import numpy as np
import torch

from repro_torch.convert import moe_shard_from_numpy
from repro_torch.distributed.context import sharding_context
from repro_torch.distributed.sharding import TRAIN_RULES
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe
from repro_torch.models.common import ModelConfig, MoEConfig

AXES = ("data", "model")


def run_rank(rank, shapes, params, x, cfg_fields, moe_fields):
    """For each mesh shape that the world's size fits: this rank's data
    shard of x through ``moe_forward`` under a sharding context (the
    expert-parallel path), and the same shard through the one-rank
    forward with every expert."""
    torch.set_num_threads(1)
    cfg = ModelConfig(**cfg_fields, moe=MoEConfig(**moe_fields), param_dtype=torch.float32,
                      compute_dtype=torch.float32)
    full = moe_shard_from_numpy(params, None)
    out = {}
    for shape in shapes:
        mesh = make_mesh(shape, AXES, device="cpu")
        n_data = shape[0]
        rows = x.shape[0] // n_data
        lo = mesh.coord("data") * rows
        xs = torch.from_numpy(x[lo:lo + rows].copy())
        mine = moe_shard_from_numpy(params, mesh)
        with sharding_context(mesh, TRAIN_RULES):
            y, aux = moe.moe_forward(mine, xs, cfg)
        y1, aux1 = moe.moe_forward(full, xs, cfg)
        out[shape] = {"coord": (mesh.coord("data"), mesh.coord("model")), "lo": lo,
                      "experts": moe.expert_rows(cfg.moe.num_experts, mesh),
                      "held": tuple(mine["wi_gate"].shape),
                      "y": y.numpy(), "aux": float(aux), "y1": y1.numpy(), "aux1": float(aux1)}
    return out
