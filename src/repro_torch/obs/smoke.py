"""Traced two-tenant DPP smoke run — the stall report's input producer.

``python -m repro_torch.obs.smoke --out trace.json [--rows N] [--device D]``
spins up a ``DPPService`` with a live :class:`repro_torch.obs.Tracer`, runs
two tenants concurrently over one warehouse (the combo-window shape of
§5.2: tenant B re-reads tenant A's table through the shared stripe cache)
and writes the Chrome-trace artifact with each tenant's registry snapshot
embedded as the ``metrics`` payload.  Both tenants' workers run extract
and transform through the torch engines on ``device`` (``cuda`` unless
asked for ``cpu``).  ``python -m repro_torch.obs.report trace.json
--check`` then validates the whole telemetry path end to end.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.core import dwrf
from repro_torch.core.datagen import DataGenConfig
from repro_torch.core.dpp import DPPService, SessionSpec
from repro_torch.core.schema import make_schema
from repro_torch.core.tectonic import TectonicFS
from repro_torch.core.transforms import default_dlrm_pipeline
from repro_torch.core.warehouse import Table, Warehouse
from repro_torch.obs import Tracer

STRIPE = 256


def _make_table(wh: Warehouse, name: str, n_parts: int, rows: int) -> Table:
    t = wh.create_table(make_schema(name, 20, 6, seed=0))
    t.generate(
        n_parts, DataGenConfig(rows_per_partition=rows, seed=1),
        dwrf.DwrfWriterOptions(flattened=True, stripe_rows=STRIPE),
    )
    return t


def _spec(t: Table) -> SessionSpec:
    dense = t.schema.dense_ids[:6]
    sparse = t.schema.sparse_ids[:3]
    pipe = default_dlrm_pipeline(dense, sparse, hash_size=500)
    return SessionSpec(
        table=t.schema.name, partitions=tuple(t.partitions),
        feature_ids=tuple(pipe.required_features()),
        transform_specs=tuple(pipe.specs),
        batch_size=256, rows_per_split=256,
        dense_keys=tuple(f"d{f}" for f in dense),
        sparse_keys=tuple(f"s{f}" for f in sparse),
        max_ids_per_feature=8,
    )


def run_smoke(out: str, rows: int = 512, latency: float = 1.0,
              device: str = "cuda") -> dict:
    """Run the traced two-tenant session pair and write the artifact.
    Returns the per-tenant batch lists (for callers asserting delivery)."""
    tracer = Tracer()
    wh = Warehouse(TectonicFS(io_latency_scale=latency))
    table = _make_table(wh, "obs_smoke", 2, rows)
    svc = DPPService(wh, tracer=tracer)
    spec = _spec(table)
    # two tenants over the same table: tenant_b's reads land on the
    # stripes tenant_a already pulled, so the trace shows both
    # storage.read (cold) and cache.hit/fill (warm) paths
    svc.create_session("tenant_a", spec, dram_share=0.2, n_workers=2,
                       device=device)
    svc.create_session("tenant_b", spec, dram_share=0.2, n_workers=2,
                       device=device)
    results = svc.run_all(timeout_s=120)
    metrics = {
        "tenants": {
            name: sess.registry.snapshot().values
            for name, sess in svc.sessions.items()
        },
        "cache": svc.tenant_summary(),
    }
    tracer.write(out, metrics=metrics)
    return results


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.smoke",
        description="traced two-tenant DPP run -> Chrome-trace artifact",
    )
    ap.add_argument("--out", required=True, help="artifact path (JSON)")
    ap.add_argument("--rows", type=int, default=512,
                    help="rows per partition (2 partitions per tenant)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    results = run_smoke(args.out, rows=args.rows, device=args.device)
    for name in sorted(results):
        print(f"{name}: {len(results[name])} batches")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
