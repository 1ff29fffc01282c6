"""End-to-end driver on the PyTorch port: train a ~100M-parameter DLRM for
a few hundred steps through the full DSI pipeline, with checkpoint/restart
along the way.

Phase 1 trains half the steps from one DPP session and stops (a trainer
"crash"); phase 2 builds a fresh trainer on the same checkpoint directory
and a fresh session, resumes from the newest complete checkpoint and
finishes.  Every stage runs on ``--device`` (``cuda`` unless asked for
``cpu``).  The checkpoint directory is a temporary one, removed when the
run ends: at ``dlrm-100m`` a checkpoint is ~1.23 GB and three are kept.

  PYTHONPATH=src python examples/torch/train_dlrm_e2e.py [--steps 200] [--device cpu]
"""
import argparse
import dataclasses
import shutil
import sys
import tempfile
from typing import Any, Dict, Tuple

from repro_torch.configs.dlrm_paper import SMOKE
from repro_torch.core.dpp import DPPSession
from repro_torch.launch.train import dlrm_dpp_batches
from repro_torch.models.common import param_count
from repro_torch.optim import OptimizerConfig
from repro_torch.train import Trainer, TrainerConfig

# ~100M params: 32 tables x 100k vocab x 32-dim = 102M embedding params
CONFIG = dataclasses.replace(
    SMOKE,
    name="dlrm-100m",
    num_dense=64,
    num_tables=32,
    vocab_per_table=100_000,
    embed_dim=32,
    max_ids_per_feature=16,
    bottom_mlp=(128, 64, 32),
    top_mlp=(256, 128, 1),
)
BATCH_SIZE, N_PARTITIONS, ROWS_PER_PARTITION, N_WORKERS = 256, 4, 8192, 3


def make_trainer(steps: int, ckpt_dir: str, device: str) -> Trainer:
    return Trainer(
        CONFIG,
        OptimizerConfig(learning_rate=1e-3, warmup_steps=20, total_steps=steps),
        TrainerConfig(checkpoint_dir=ckpt_dir, checkpoint_every=50, max_steps=steps),
        device=device,
    )


def run_phase(trainer: Trainer, device: str) -> Tuple[Dict[str, Any], DPPSession]:
    """``trainer.fit`` on a fresh DPP session, which is stopped after."""
    batches, session = dlrm_dpp_batches(
        CONFIG, batch_size=BATCH_SIZE, n_partitions=N_PARTITIONS,
        rows_per_partition=ROWS_PER_PARTITION, n_workers=N_WORKERS, device=device,
    )
    try:
        return trainer.fit(batches), session
    finally:
        session.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    ckpt_dir = tempfile.mkdtemp(prefix="dlrm_ckpt_")
    try:
        trainer = make_trainer(args.steps, ckpt_dir, args.device)
        print(f"DLRM params: {param_count(trainer.model.params()) / 1e6:.1f}M")

        # phase 1: train halfway, then simulate a trainer crash
        trainer.cfg.max_steps = args.steps // 2
        state, _ = run_phase(trainer, args.device)
        print(f"phase 1 done at step {state['step']}; 'crashing' and restoring...")

        # phase 2: fresh trainer restores from the checkpoint and finishes
        trainer2 = make_trainer(args.steps, ckpt_dir, args.device)
        state2, _ = run_phase(trainer2, args.device)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    losses = [m.loss for m in trainer.history] + [m.loss for m in trainer2.history]
    print(f"resumed at step {trainer2.history[0].step}, finished at {state2['step']}")
    print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"stall fraction phase2: {trainer2.stall_fraction():.3f}")
    if not trainer2.history[0].step > args.steps // 4:
        print("did not resume from checkpoint", file=sys.stderr)
        return 1
    if not losses[-1] < losses[0]:
        print("the loss did not fall", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
