"""DLRM sparse training: the port's one-rank ``launch.steps`` train step
(``make_train_step`` of a ``DLRMConfig``, the vocab-sharded sparse step
on a one-rank mesh: pooling, the MLPs' AdamW and the tables' row-wise
AdaGrad, in place) fed by a DPP session.

Set-up: the benchmark's raw partitions are written to a warehouse
table; a DPP session at a fixed worker count (``auto_scale=False``)
serves the pool of batches through the decode and transform engines on
the run's device, held in host memory as the client delivers them and
ordered by their labels' bytes (so the order is the seed's and not the
threads'); the tables, accumulator and MLPs are the benchmark's, on the
card.  The steps the reference follows run first (after the first, each
MLP leaf's gradient norm is read from AdamW's first moment, mu / (1 -
beta1), and each table's from the AdaGrad accumulator, sqrt(E x its sum);
after the last, each leaf's change over the rows those steps read), then
the warm-up steps.  A step hands its host batch to the card
(``StepBundle.shard_batch``, a ``handoff`` span), runs the step and reads
its loss on the host, as ``Trainer.fit`` does.  The window cycles the
pool.  Once it has closed, the pool is held to the plain transform of
the raw partitions, and the reference follows the first steps.
"""
from __future__ import annotations

import gc
import socket
from typing import Dict, List

import numpy as np
import torch

from dsibench import compare, counts, generate
from dsibench import weights as W
from dsibench.harness import BenchmarkError
from dsibench.reference import dpp_transform
from dsibench.runners import optimizer_config, program_config

BATCH_KEYS = ("sparse_ids", "sparse_mask", "label")


def serve_pool(spec, table, traffic, device) -> List[Dict[str, np.ndarray]]:
    """The batches a DPP session serves from ``table``, ordered by their
    labels' bytes."""
    from repro_torch.core.dpp import DPPSession

    session = DPPSession(spec, table, n_workers=traffic["workers"], auto_scale=False,
                         engine="torch", decode_engine="torch", device=str(device))
    session.start()
    pool = []
    try:
        while len(pool) < traffic["pool"]:
            b = session.clients[0].get_batch(timeout=traffic["batch_timeout_s"])
            if b is None:
                raise BenchmarkError(f"the DPP session served {len(pool)} of "
                                     f"{traffic['pool']} batches in time")
            pool.append({k: np.asarray(v) for k, v in b.items()})
    finally:
        session.stop()
    return sorted(pool, key=lambda b: b["label"].tobytes())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Session:
    units = "samples"

    def __init__(self, config, traffic, seed, device, log):
        import torch.distributed as dist

        from repro_torch.launch.mesh import Mesh
        from repro_torch.launch.steps import make_train_step
        from repro_torch.optim import adamw_init

        m = self.model = config["model"]
        self.opt = config["optimizer"]
        self.seed, self.device, self.log = seed, device, log
        self.batch, self.n_check = traffic["batch"], traffic["check_steps"]
        table, self.spec, self.raws, self.plan = generate.dpp_inputs(m, traffic, seed)
        self.pool = serve_pool(self.spec, table, traffic, device)
        del table
        cuda = torch.device(device).type == "cuda"
        dist.init_process_group("nccl" if cuda else "gloo",
                                init_method=f"tcp://127.0.0.1:{_free_port()}",
                                world_size=1, rank=0)
        self.mesh = Mesh((1, 1), ("data", "model"), device=device)
        opt_cfg = optimizer_config(config)
        self.bundle = make_train_step(program_config(config), self.mesh, self.batch, 0,
                                      opt_cfg=opt_cfg, device=device)
        tables, mlp = W.dlrm_weights(m, seed, device)
        start_mlp = {k: v.clone() for k, v in mlp.items()}
        self.params = dict(sorted({**mlp, "tables": tables}.items()))
        self.opt_state = {"adam": adamw_init(mlp, opt_cfg),
                          "acc": torch.zeros(tables.shape[:2], dtype=torch.float32,
                                             device=tables.device)}

        # the rows the checked steps read, as the program's batches name them
        t, v, e = m["num_tables"], m["vocab_per_table"], m["embed_dim"]
        flat = [np.clip(b["sparse_ids"].astype(np.int64), 0, v - 1)
                + np.arange(t, dtype=np.int64)[None, :, None] * v
                for b in self.pool[:self.n_check]]
        rows = np.unique(np.concatenate([f[b["sparse_mask"] > 0]
                                         for f, b in zip(flat, self.pool)]))
        rows_t = torch.as_tensor(rows, device=tables.device)
        start_rows = tables.view(-1, e)[rows_t].clone()

        self.losses = [self._step(self.pool[0])]
        b1 = self.opt["beta1"]
        adam, acc = self.opt_state["adam"], self.opt_state["acc"]
        self.grad = {k: float(torch.linalg.vector_norm(mu)) / (1 - b1)
                     for k, mu in adam["mu"].items()}
        sums = acc.sum(dim=1)
        for tt in range(t):
            self.grad[f"tables.{tt}"] = float(torch.sqrt(sums[tt] * e))
        for i in range(1, self.n_check):
            self.losses.append(self._step(self.pool[i]))
        self.change = {k: float(torch.linalg.vector_norm(self.params[k] - start_mlp[k]))
                       for k in start_mlp}
        d = torch.linalg.vector_norm(tables.view(-1, e)[rows_t] - start_rows, dim=1) ** 2
        table_of = rows_t // v
        for tt in range(t):
            self.change[f"tables.{tt}"] = float(torch.sqrt(d[table_of == tt].sum()))
            self.change[f"acc.{tt}"] = float(torch.linalg.vector_norm(acc[tt]))
        del start_rows, start_mlp, d
        self.at = self.n_check
        for _ in range(traffic["warmup_steps"]):
            self._step(self.pool[self.at % len(self.pool)])
            self.at += 1

        flops = counts.dlrm_step_flops(m, self.batch)
        self.pool_bytes = [counts.dlrm_step_bytes(m, b) for b in self.pool]
        self.step_flops = flops
        self.step_counts: Dict[str, List[float]] = {"flops": [], "bytes": []}
        log(f"[dlrm_sparse] pool of {len(self.pool)} batches of {self.batch}; live slots "
            f"{[int(b['sparse_mask'].sum()) for b in self.pool]}; bytes a step "
            f"{self.pool_bytes}; flops a step {flops}; losses {self.losses}")

    def _step(self, batch) -> float:
        dev = self.bundle.shard_batch(batch)
        self.params, self.opt_state, met = self.bundle.fn(self.params, self.opt_state, dev)
        return float(met["loss"])

    def run_window(self, win) -> None:
        flops, nbytes = [], []
        while True:
            k = self.at % len(self.pool)
            start = win.clock()
            with win.span("handoff"):
                dev = self.bundle.shard_batch(self.pool[k])
            with win.span("step"):
                self.params, self.opt_state, met = self.bundle.fn(self.params, self.opt_state,
                                                                  dev)
                loss = float(met["loss"])
            win.step(start, win.clock(), self.batch, loss)
            flops.append(self.step_flops)
            nbytes.append(self.pool_bytes[k])
            self.at += 1
            if not win.due():
                break
        self.step_counts = {"flops": flops, "bytes": nbytes}

    def close_program(self) -> None:
        import torch.distributed as dist

        del self.bundle, self.params, self.opt_state
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        dist.destroy_process_group()

    def check(self, reference) -> Dict[str, float]:
        s = self.spec
        want = sorted((dpp_transform.transform(raw, self.plan, s.dense_keys, s.sparse_keys,
                                               s.max_ids_per_feature) for raw in self.raws),
                      key=lambda b: b["label"].tobytes())
        bad, dense = 0, 0.0
        for got, ref in zip(self.pool, want):
            for k in BATCH_KEYS:
                bad += (int(np.sum(got[k] != ref[k])) if got[k].shape == ref[k].shape
                        else ref[k].size)
            dense = (max(dense, float(np.max(np.abs(got["dense"] - ref["dense"]))))
                     if got["dense"].shape == ref["dense"].shape else float("inf"))
        bad += sum(b["label"].size for b in want[len(self.pool):])
        ref = reference.run(self.model, self.opt, self.seed, want[:self.n_check], self.device)
        grad, grad_leaf = compare.worst_leaf(self.grad, ref["grad"])
        keep = compare.moved(ref["change"], ref["grad"],
                             lambda k: k.replace("acc.", "tables.", 1))
        change, change_leaf = compare.worst_leaf(self.change, ref["change"], keep)
        gaps = compare.loss_gaps(self.losses, ref["losses"])
        mid = compare.median_leaf(self.change, ref["change"], keep)
        self.log(f"[dlrm_sparse] losses {self.losses} against the reference's "
                 f"{ref['losses']}; worst grad leaf {grad_leaf}, worst change leaf "
                 f"{change_leaf} (of {len(keep)} of {len(ref['change'])} leaves moved; the median "
                 f"leaf's change gap {mid:.3e}); step loss gaps {gaps}; "
                 f"{ref['rows']} rows read by the checked steps")
        return {"batches": bad, "dense": dense, "loss": max(gaps), "grad": grad,
                "change": change}


def setup(config, traffic, seed, device, log) -> Session:
    return Session(config, traffic, seed, device, log)
