"""Reproduce the paper's storage characterization on a synthetic table with
the PyTorch port: selective reading (Table 5), I/O sizes (Table 6), byte
popularity (Fig 7), and a pointer to the Table 12 optimization ladder
(FF -> CR -> FR -> LS).  Every job's ``TableReader`` decodes its stripes
through the torch decode engine on ``--device`` (``cuda`` unless asked
for ``cpu``); the decode engine never changes the bytes read, so every
number printed equals the reference example's
(``examples/dsi_characterization.py``).

  PYTHONPATH=src python examples/torch/dsi_characterization.py [--device cpu]
"""
import argparse
import sys

import numpy as np

from repro_torch.core import dwrf
from repro_torch.core.datagen import DataGenConfig
from repro_torch.core.decode import TorchDecodeEngine
from repro_torch.core.reader import TableReader
from repro_torch.core.schema import make_schema
from repro_torch.core.warehouse import Warehouse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    schema = make_schema("rm1_like", n_dense=600, n_sparse=90, seed=0)
    wh = Warehouse()
    table = wh.create_table(schema)
    table.generate(
        2, DataGenConfig(rows_per_partition=2048, seed=1),
        dwrf.DwrfWriterOptions(flattened=True, stripe_rows=512),
    )
    rng = np.random.default_rng(0)

    # jobs select ~11% of features, weighted by popularity (drives Fig 7)
    fids = np.array(schema.logged_ids)
    pops = np.array([schema.feature(f).popularity for f in fids])
    pops /= pops.sum()
    for job in range(8):
        proj = rng.choice(fids, size=len(fids) // 9, replace=False, p=pops)
        reader = TableReader(table, sorted(proj.tolist()),
                             decode_engine=TorchDecodeEngine(args.device))
        res = reader.read_partition(table.partitions[job % 2])
        reader.finish_job()
    stats = reader.projection_stats()
    print("Table 5 (one job):", {k: round(v, 1) for k, v in stats.items() if "pct" in k},
          "(paper: ~9-11% features, 21-37% bytes)")

    io = np.array(res.io_sizes)
    print(f"Table 6 I/O sizes: mean={io.mean():.0f}B p50={np.percentile(io,50):.0f}B "
          f"p95={np.percentile(io,95):.0f}B n={len(io)}")

    stored = {
        f: 0.0 for f in fids
    }
    for m in table.partitions.values():
        for s in m.footer.stripes:
            for st in s.streams:
                if st.fid >= 0:
                    stored[st.fid] = stored.get(st.fid, 0.0) + st.length
    frac = table.popularity.bytes_fraction_for_traffic(stored, 0.8)
    print(f"Fig 7: {frac*100:.0f}% of stored bytes serve 80% of read traffic "
          f"(paper: 18-39%)")

    print("\nTable 12 ladder: see benchmarks/bench_optimizations.py for the "
          "full normalized throughput table.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
