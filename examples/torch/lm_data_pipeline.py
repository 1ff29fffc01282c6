"""LM training through the DSI pipeline on the PyTorch port: a token
corpus stored as DWRF columnar partitions on simulated Tectonic,
selectively read, packed into fixed-length sequences, and fed to a
smoke-scale qwen3 model, every stage on ``--device`` (``cuda`` unless
asked for ``cpu``; on the card extract runs through the decode kernels).

  PYTHONPATH=src python examples/torch/lm_data_pipeline.py [--device cpu]
"""
import argparse
import sys

from repro_torch import configs as cfglib
from repro_torch.core import tokens as T
from repro_torch.core.warehouse import Warehouse
from repro_torch.device import resolve
from repro_torch.optim import OptimizerConfig
from repro_torch.train import Trainer, TrainerConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve(args.device, "lm_data_pipeline")

    cfg = cfglib.get_smoke_config("qwen3-8b")
    wh = Warehouse()
    table = T.build_corpus(wh, n_partitions=3, docs_per_partition=96,
                           vocab_size=cfg.vocab_size, seed=0)
    print(f"corpus: {table.total_rows} docs, {table.total_bytes/1e6:.1f} MB on "
          f"{len(table.fs.nodes)} storage nodes")

    engine = "torch" if device.type == "cuda" else None
    batches = T.lm_batches_from_table(table, seq_len=128, batch_size=8, decode_engine=engine)
    trainer = Trainer(
        cfg,
        OptimizerConfig(learning_rate=3e-3, warmup_steps=5, total_steps=40),
        TrainerConfig(max_steps=40),
        device=device,
    )
    trainer.fit(batches)
    losses = [m.loss for m in trainer.history]
    print(f"steps={len(losses)} on {trainer.device}; loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    st = table.fs.stats
    print(f"storage I/O: {st.num_ios} reads, {st.bytes_read/1e6:.1f} MB, "
          f"effective {st.effective_throughput_MBps:.0f} MB/s (HDD model)")
    if not losses[-1] < losses[0]:
        print("the loss did not fall", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
