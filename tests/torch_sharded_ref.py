"""Inputs and the reference side of ``tests/test_torch_dlrm_sharded.py``.

``inputs()`` draws every input with numpy from fixed seeds (no JAX).  Run
as a script, in a process of its own with eight virtual host devices,

    XLA_FLAGS=--xla_force_host_platform_device_count=8 PYTHONPATH=src \\
        python tests/torch_sharded_ref.py OUT.npz

it runs the reference's sharded DLRM ops, its
``_make_dlrm_sparse_train_step`` and its ``Trainer(mesh=...)`` on meshes
(1, 4), (2, 2) and (4, 1) with Auto axes over those inputs and writes the
results to one npz (keys ``<what>/<mesh>/<leaf>``).
"""
import dataclasses
import math
import sys

import numpy as np

MESHES = ((1, 4), (2, 2), (4, 1))
VOCAB, VOCAB_ODD = 1600, 1602
BATCH = 8
STEPS = 3
LR = 0.05
OPT = dict(learning_rate=1e-2, warmup_steps=2, total_steps=100)


def hard_batch(cfg, n, seed):
    """Ids out of range on both sides, duplicates within a bag and across
    bags, the last row repeated, fractional masks and empty bags."""
    rng = np.random.default_rng(seed)
    v, t, l = cfg.vocab_per_table, cfg.num_tables, cfg.max_ids_per_feature
    ids = rng.integers(0, v, (n, t, l)).astype(np.int32)
    ids[0, 0, :3] = (-5, v, v + 7)
    ids[1, :, 1] = ids[1, :, 0]               # duplicates within a bag
    ids[2] = ids[1]                           # and across bags
    ids[3, 1, :] = v - 1                      # the last row, l times
    mask = rng.random((n, t, l)).astype(np.float32)
    mask[rng.random((n, t, l)) < 0.3] = 0.0
    mask[4, 2] = 0.0                          # an empty bag
    mask[5] = 1.0
    return {
        "dense": rng.normal(0, 1, (n, cfg.num_dense)).astype(np.float32),
        "sparse_ids": ids,
        "sparse_mask": mask,
        "label": rng.integers(0, 2, n).astype(np.float32),
    }


EDGE_BATCH = 1280
EDGE_CASES = ("pads", "hot_row", "empty_bag", "last_row", "nan_bag", "all")
HOT_ROW_TIMES = 10_000


def edge_inputs(cfg, case, seed=3):
    """A table update's inputs at ``cfg``'s widths, ``EDGE_BATCH`` bags of
    fractional weights, with one of ``EDGE_CASES`` ("all": every one):
    pads (id 0, mask 0) in ~83% of the slots; one row of table 3 named by
    ``HOT_ROW_TIMES`` slots; an all-pad bag; the last row of the last
    table (an id past it clips there); a bag whose d(pooled) holds a NaN,
    with pads and one live slot."""
    rng = np.random.default_rng(seed)
    v, t, l, e = cfg.vocab_per_table, cfg.num_tables, cfg.max_ids_per_feature, cfg.embed_dim
    n = EDGE_BATCH
    ids = rng.integers(0, v, (n, t, l)).astype(np.int32)
    mask = (0.25 + rng.random((n, t, l))).astype(np.float32)
    dpooled = rng.normal(0, 1, (n, t, e)).astype(np.float32)

    def on(c):
        return case in (c, "all")

    if on("pads"):
        pad = rng.random((n, t, l)) < 0.83
        ids[pad], mask[pad] = 0, 0.0
    if on("hot_row"):
        k = HOT_ROW_TIMES // l
        ids[:k, 3], mask[:k, 3] = v // 2 + 3, 1.0
    if on("empty_bag"):
        ids[n - 5, 2], mask[n - 5, 2] = 0, 0.0
    if on("last_row"):
        ids[n - 4, t - 1, :3], mask[n - 4, t - 1, :3] = (v - 1, v - 1, v + 5), 1.0
    if on("nan_bag"):
        ids[n - 3, 4], mask[n - 3, 4] = 0, 0.0
        ids[n - 3, 4, 0], mask[n - 3, 4, 0] = 11, 1.0
        dpooled[n - 3, 4, 2] = np.nan
    return {"tables": rng.normal(0, 0.5, (t, v, e)).astype(np.float32),
            "acc": (0.1 * rng.random((t, v))).astype(np.float32),
            "dpooled": dpooled, "sparse_ids": ids, "sparse_mask": mask}


def _mlp(dims, rng):
    out = {}
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"w{i}"] = (rng.normal(0, 1, (din, dout)) / math.sqrt(din)).astype(np.float32)
        out[f"b{i}"] = (0.1 * rng.normal(0, 1, (dout,))).astype(np.float32)
    return out


def inputs(cfg):
    """Every input, for ``cfg`` (``dlrm-smoke``): the ops' tables,
    accumulator, d(pooled) and batch at vocab 1600 ("ops") and 1602
    ("odd"), ``edge_inputs``' every case at 1600 ("edge"), initial parameters ("params0", the reference's tree) and
    six training batches ("batches")."""
    rng = np.random.default_rng(1)
    out = {}
    for tag, v in (("ops", VOCAB), ("odd", VOCAB_ODD)):
        c = dataclasses.replace(cfg, vocab_per_table=v)
        t, e = c.num_tables, c.embed_dim
        out[tag] = {"tables": rng.normal(0, 0.5, (t, v, e)).astype(np.float32),
                    "acc": (0.1 * rng.random((t, v))).astype(np.float32),
                    "dpooled": rng.normal(0, 1, (BATCH, t, e)).astype(np.float32),
                    **hard_batch(c, BATCH, seed=2)}
    c = dataclasses.replace(cfg, vocab_per_table=VOCAB)
    out["edge"] = edge_inputs(c, "all")
    n_pairs = (c.num_tables + 1) * c.num_tables // 2
    out["params0"] = {
        "tables": rng.normal(0, 0.05, (c.num_tables, VOCAB, c.embed_dim)).astype(np.float32),
        "bottom": _mlp((c.num_dense,) + c.bottom_mlp, rng),
        "top": _mlp((c.bottom_mlp[-1] + n_pairs,) + c.top_mlp, rng),
    }
    out["batches"] = [hard_batch(c, BATCH, seed=10 + i) for i in range(2 * STEPS)]
    return out


def _flat(prefix, tree, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(f"{prefix}{k}.", v, out)
        else:
            out[f"{prefix}{k}"] = np.asarray(v)


def main(path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro import configs
    from repro.distributed.sharding import TRAIN_RULES
    from repro.launch.steps import _make_dlrm_sparse_train_step
    from repro.models import build_model
    from repro.optim import OptimizerConfig, adamw_init
    from repro.train import Trainer, TrainerConfig

    def mesh_of(shape):
        return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:4])

    smoke = configs.get_smoke_config("dlrm-paper")
    cfg = dataclasses.replace(smoke, vocab_per_table=VOCAB)
    opt_cfg = OptimizerConfig(**OPT)
    ins = inputs(smoke)
    out = {}
    for tag, v in (("ops", VOCAB), ("odd", VOCAB_ODD), ("edge", VOCAB)):
        m = build_model(dataclasses.replace(smoke, vocab_per_table=v))
        x = {k: jnp.asarray(a) for k, a in ins[tag].items()}
        for shape in MESHES:
            mesh = mesh_of(shape)
            pooled = jax.jit(lambda tb, b: m.pooled_embeddings_sharded(tb, b, mesh))(
                x["tables"], x)
            tb, ac = jax.jit(lambda tb, ac, dp, b: m.sparse_table_update_sharded(
                tb, ac, dp, b, LR, mesh))(x["tables"], x["acc"], x["dpooled"], x)
            out[f"{tag}/{shape}/pooled"] = np.asarray(pooled)
            out[f"{tag}/{shape}/tables"] = np.asarray(tb)
            out[f"{tag}/{shape}/acc"] = np.asarray(ac)

    model = build_model(cfg)
    params0, batches = ins["params0"], ins["batches"]
    mlp = {"bottom": params0["bottom"], "top": params0["top"]}
    for shape in MESHES:
        mesh = mesh_of(shape)
        step = _make_dlrm_sparse_train_step(cfg, model, mesh, BATCH, TRAIN_RULES, opt_cfg).jit()
        params = jax.tree.map(np.copy, params0)
        opt = {"adam": adamw_init(mlp, opt_cfg),
               "acc": np.zeros((cfg.num_tables, VOCAB), np.float32)}
        losses, norms = [], []
        for b in batches[:STEPS]:
            params, opt, metrics = jax.tree.map(np.asarray, step(params, opt, b))
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        out[f"step/{shape}/loss"] = np.array(losses)
        out[f"step/{shape}/grad_norm"] = np.array(norms)
        _flat(f"step/{shape}/params/", params, out)
        out[f"step/{shape}/acc"] = np.asarray(opt["acc"])

        trainer = Trainer(cfg, opt_cfg, TrainerConfig(max_steps=STEPS), mesh=mesh)
        state = {"params": params0, "opt": adamw_init(params0, opt_cfg), "step": 0}
        state = trainer.fit(batches[:STEPS], state)
        out[f"trainer/{shape}/loss"] = np.array([h.loss for h in trainer.history])
        out[f"trainer/{shape}/grad_norm"] = np.array([h.grad_norm for h in trainer.history])
        _flat(f"trainer/{shape}/params/", jax.tree.map(np.asarray, state["params"]), out)
        _flat(f"trainer/{shape}/adamw/", jax.tree.map(np.asarray, state["opt"]), out)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
