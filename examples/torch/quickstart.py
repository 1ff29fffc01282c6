"""Quickstart on the PyTorch port: the full DSI pipeline in ~50 lines.

Synthesizes a feature table into the warehouse (DWRF columnar files with
feature flattening on simulated Tectonic/HDD storage), launches a DPP
session (Master + stateless Workers + Client) whose extract and transform
run through the torch engines, and trains a small DLRM on the streamed
tensor batches, every stage on ``--device`` (``cuda`` unless asked for
``cpu``).

  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse
import sys

from repro_torch import configs as cfglib
from repro_torch.launch.train import dlrm_dpp_batches
from repro_torch.optim import OptimizerConfig
from repro_torch.train import Trainer, TrainerConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = cfglib.get_smoke_config("dlrm-paper")
    batches, session = dlrm_dpp_batches(cfg, batch_size=128, device=args.device)

    trainer = Trainer(
        cfg,
        OptimizerConfig(learning_rate=1e-3, warmup_steps=5, total_steps=30),
        TrainerConfig(max_steps=30),
        device=args.device,
    )
    try:
        state = trainer.fit(batches)
    finally:
        session.stop()

    losses = [m.loss for m in trainer.history]
    print(f"trained {state['step']} steps on {trainer.device}; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"GPU-side data-stall fraction: {trainer.stall_fraction():.3f}")
    m = session.worker_metrics()
    print(
        "DPP worker bytes: storage_rx=%d extract_out=%d tensors_tx=%d"
        % (m.storage_rx_bytes, m.extract_out_bytes, m.tx_bytes)
    )
    print("DPP cycle breakdown:", {k: round(v, 3) for k, v in m.cycle_breakdown().items()})
    if not losses[-1] < losses[0]:
        print("the loss did not fall", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
