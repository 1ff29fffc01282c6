"""End-to-end training entry point: warehouse -> DPP -> trainer.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-paper --steps 50 --smoke

DLRM runs the full paper pipeline (synthetic warehouse partitions -> DPP
extract/transform/load -> DLRM train steps), every stage on ``--device``
(``cuda`` unless asked for ``cpu``).  ``dlrm_dpp_batches`` builds the
synthetic warehouse and the DPP session the way the reference's
``repro.launch.train.dlrm_dpp_batches`` does and yields the tensor
batches a trainer's client consumes.  Only ``dlrm-paper`` is ported; the
LM archs come with their own slice.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, Iterator, Tuple

import numpy as np

from repro_torch import configs as cfglib
from repro_torch.core import dwrf
from repro_torch.core.datagen import DataGenConfig
from repro_torch.core.dpp import DPPSession, SessionSpec
from repro_torch.core.schema import make_schema
from repro_torch.core.transforms import default_dlrm_pipeline
from repro_torch.core.warehouse import Table, Warehouse
from repro_torch.models.dlrm import DLRMConfig
from repro_torch.optim import OptimizerConfig
from repro_torch.train import Trainer, TrainerConfig


def dlrm_dpp_table(cfg: DLRMConfig, batch_size: int, n_partitions: int = 2,
                   rows_per_partition: int = 2048) -> Tuple[Table, SessionSpec]:
    """The synthetic warehouse table and the DPP session spec that
    ``dlrm_dpp_batches`` serves."""
    schema = make_schema("dlrm_table", n_dense=cfg.num_dense * 3,
                         n_sparse=max(cfg.num_tables * 3, 8), seed=0)
    wh = Warehouse()
    table = wh.create_table(schema)
    table.generate(
        n_partitions,
        DataGenConfig(rows_per_partition=rows_per_partition, seed=1),
        dwrf.DwrfWriterOptions(flattened=True, stripe_rows=512),
    )
    dense = schema.dense_ids[: cfg.num_dense]
    n_gen = max(cfg.num_tables // 4, 0)
    sparse = schema.sparse_ids[: cfg.num_tables - n_gen]
    pipe = default_dlrm_pipeline(
        dense, sparse, hash_size=cfg.vocab_per_table,
        firstx=cfg.max_ids_per_feature, n_derived=n_gen,
    )
    spec = SessionSpec(
        table=schema.name,
        partitions=tuple(range(n_partitions)),
        feature_ids=tuple(pipe.required_features()),
        transform_specs=tuple(pipe.specs),
        batch_size=batch_size,
        rows_per_split=512,
        dense_keys=tuple(f"d{f}" for f in dense),
        sparse_keys=tuple(f"s{f}" for f in sparse) + tuple(f"g{j}" for j in range(n_gen)),
        max_ids_per_feature=cfg.max_ids_per_feature,
    )
    return table, spec


def dlrm_dpp_batches(
    cfg: DLRMConfig,
    batch_size: int,
    n_partitions: int = 2,
    rows_per_partition: int = 2048,
    n_workers: int = 2,
    *,
    device: str = "cuda",
    engine: str = "torch",
    decode_engine: str = "torch",
) -> Tuple[Iterator[Dict[str, np.ndarray]], DPPSession]:
    """Build a synthetic warehouse + DPP session; yield tensor batches.

    ``engine``/``decode_engine`` pick the transform and extract engines
    (``"torch"`` on ``device``, or the ``"numpy"`` reference); every
    choice yields byte-identical batches."""
    table, spec = dlrm_dpp_table(cfg, batch_size, n_partitions, rows_per_partition)
    session = DPPSession(spec, table, n_workers=n_workers, auto_scale=True,
                         engine=engine, decode_engine=decode_engine, device=device)
    session.start()

    def gen():
        while True:
            b = session.clients[0].get_batch(timeout=5.0)
            if b is None:
                if session.master.finished and all(w.buffered == 0 for w in session.workers):
                    session.stop()
                    return
                continue
            yield b

    return gen(), session


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dlrm-paper", choices=["dlrm-paper"],
                    help="the port trains DLRM only; LM training is not ported")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = cfglib.get_smoke_config(args.arch) if args.smoke else cfglib.get_config(args.arch)
    trainer = Trainer(
        cfg,
        OptimizerConfig(learning_rate=1e-3, warmup_steps=10, total_steps=args.steps),
        TrainerConfig(max_steps=args.steps),
        device=args.device,
    )
    batches, session = dlrm_dpp_batches(cfg, args.batch_size, device=args.device)

    t0 = time.time()
    try:
        state = trainer.fit(batches)
    finally:
        session.stop()
    wall = time.time() - t0
    losses = [m.loss for m in trainer.history]
    print(f"arch={cfg.name} device={trainer.device} steps={state['step']} wall_s={wall:.1f}")
    print(f"loss: first={losses[0]:.4f} last={losses[-1]:.4f}")
    print(f"data_stall_fraction={trainer.stall_fraction():.3f}")
    m = session.worker_metrics()
    print(f"dpp: storage_rx={m.storage_rx_bytes} tx={m.tx_bytes} "
          f"breakdown={ {k: round(v, 3) for k, v in m.cycle_breakdown().items()} }")
    return 0 if losses[-1] < losses[0] else 1


if __name__ == "__main__":
    sys.exit(main())
