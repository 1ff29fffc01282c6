"""Table-7-style stall attribution from a trace artifact.

``python -m repro_torch.obs.report ARTIFACT [--json] [--check]`` consumes a
Chrome-trace JSON written by :meth:`repro_torch.obs.Tracer.write` (optionally
carrying a registry-snapshot ``metrics`` payload) and prints, per tenant
plus an ``ALL`` aggregate:

  * the share of wall-clock the trainer spent blocked (``client.stall``)
    attributed across storage reads, cache fills, extract+transform and
    load/materialize — the paper's Table 7 breakdown — plus the directly
    measured tiered-embedding fetch share (``embed.fetch``) and
    the remainder as compute.  Shares sum to 100 by construction.
  * bytes by source tier (storage vs stripe-cache RX, DRAM/flash
    resident), the over-read factor (stripe rows decoded per fresh row
    served — Table 9's E-stage amplification) and the fused-kernel
    fraction of transform time.

``--check`` validates the artifact structurally (the schema Perfetto
loads: complete ``X`` events, sorted non-negative timestamps, no span
left open) and the report's accounting identity, exiting non-zero on any
violation.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

# span name -> stall-attribution bucket (Table 7 rows)
_BUCKETS = {
    "storage.read": "storage",
    "cache.fill": "cache_fill",
    "extract.decode": "transform",
    "transform.fused": "transform",
    "transform.fallback": "transform",
    "load.materialize": "load",
}
_WEIGHTS = ("storage", "cache_fill", "transform", "load")
# directly-measured (non-blocked) trainer-side categories: unlike the
# _BUCKETS weights these are not a split of client.stall — they are their
# own slice of the wall clock (tiered embedding lookups)
_EMBED_SPAN = "embed.fetch"
_SHARE_KEYS = (
    "storage_pct", "cache_fill_pct", "transform_pct", "load_pct",
    "embed_fetch_pct", "compute_pct", "unattributed_pct",
)
# registry-snapshot names the byte/efficiency columns read
_SNAP_COLS = (
    "worker.storage_rx_bytes", "worker.cache_rx_bytes",
    "worker.rows_decoded", "worker.rows_done", "worker.rows_from_cache",
    "worker.transform_fused_s", "worker.transform_fallback_s",
)


def _tenant_of(ev: Dict[str, Any]) -> str:
    return str((ev.get("args") or {}).get("tenant", ""))


def _accumulate(evs: List[Dict[str, Any]]) -> Dict[str, float]:
    """Raw per-tenant sums (µs): wall, stall and one weight per bucket."""
    wall = float(sum(e["dur"] for e in evs if e["name"] == "session.run"))
    if wall <= 0.0 and evs:
        # no session.run span (e.g. a bare trainer trace): the tenant's
        # wall clock is the extent of its events
        wall = float(
            max(e["ts"] + e["dur"] for e in evs) - min(e["ts"] for e in evs)
        )
    stall = min(
        float(sum(e["dur"] for e in evs if e["name"] == "client.stall")),
        wall,
    )
    embed = min(
        float(sum(e["dur"] for e in evs if e["name"] == _EMBED_SPAN)),
        wall - stall,
    )
    row = {"wall_us": wall, "stall_us": stall, "embed_us": embed}
    for b in _WEIGHTS:
        row[f"w_{b}_us"] = 0.0
    for e in evs:
        b = _BUCKETS.get(e["name"])
        if b is not None:
            row[f"w_{b}_us"] += e["dur"]
    return row


def _shares(raw: Dict[str, float]) -> Dict[str, float]:
    """Split the blocked share across buckets proportionally to their
    span time; the identity ``sum(shares) == 100`` holds by
    construction (blocked + compute partition the wall clock)."""
    out = {k: 0.0 for k in _SHARE_KEYS}
    wall = raw["wall_us"]
    if wall <= 0.0:
        out["compute_pct"] = 100.0
        return out
    stall_pct = 100.0 * raw["stall_us"] / wall
    embed_pct = 100.0 * raw.get("embed_us", 0.0) / wall
    out["embed_fetch_pct"] = embed_pct
    out["compute_pct"] = 100.0 - stall_pct - embed_pct
    wsum = sum(raw[f"w_{b}_us"] for b in _WEIGHTS)
    if wsum > 0.0:
        for b in _WEIGHTS:
            out[f"{b}_pct"] = stall_pct * raw[f"w_{b}_us"] / wsum
    else:
        # blocked time with zero attributable span time: surface it
        # instead of silently inflating a bucket
        out["unattributed_pct"] = stall_pct
    return out


def _metric_cols(snap: Dict[str, float],
                 cache: Dict[str, float]) -> Dict[str, float]:
    fresh = snap.get("worker.rows_done", 0) - snap.get(
        "worker.rows_from_cache", 0
    )
    decoded = snap.get("worker.rows_decoded", 0)
    tf = snap.get("worker.transform_fused_s", 0.0)
    tb = snap.get("worker.transform_fallback_s", 0.0)
    return {
        "storage_rx_bytes": float(snap.get("worker.storage_rx_bytes", 0)),
        "cache_rx_bytes": float(snap.get("worker.cache_rx_bytes", 0)),
        "dram_bytes_stored": float(cache.get("dram_bytes_stored", 0.0)),
        "flash_bytes_stored": float(cache.get("flash_bytes_stored", 0.0)),
        "over_read": decoded / fresh if fresh > 0 else 1.0,
        "fused_frac": tf / (tf + tb) if (tf + tb) > 0.0 else 0.0,
    }


def build_report(doc: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
    """Per-tenant rows (plus ``ALL``): raw µs sums, percentage shares
    and the byte/efficiency columns from the ``metrics`` payload."""
    events = [
        e for e in doc.get("traceEvents", []) if e.get("ph") == "X"
    ]
    metrics = doc.get("metrics") or {}
    tenant_snaps = metrics.get("tenants") or {}
    tenant_cache = metrics.get("cache") or {}
    tenants = sorted({_tenant_of(e) for e in events} | set(tenant_snaps))
    rows: Dict[str, Dict[str, float]] = {}
    total_raw: Dict[str, float] = {}
    total_snap: Dict[str, float] = {}
    total_cache: Dict[str, float] = {}
    for tenant in tenants:
        evs = [e for e in events if _tenant_of(e) == tenant]
        raw = _accumulate(evs)
        snap = tenant_snaps.get(tenant) or {}
        cache = tenant_cache.get(tenant) or {}
        rows[tenant] = {**raw, **_shares(raw), **_metric_cols(snap, cache)}
        for k, v in raw.items():
            total_raw[k] = total_raw.get(k, 0.0) + v
        for k in _SNAP_COLS:
            total_snap[k] = total_snap.get(k, 0.0) + snap.get(k, 0)
        for k in ("dram_bytes_stored", "flash_bytes_stored"):
            total_cache[k] = total_cache.get(k, 0.0) + cache.get(k, 0.0)
    if total_raw:
        rows["ALL"] = {
            **total_raw,
            **_shares(total_raw),
            **_metric_cols(total_snap, total_cache),
        }
    return rows


def check(doc: Dict[str, Any]) -> List[str]:
    """Structural + accounting validation; returns human-readable
    violations (empty = artifact is Perfetto-loadable and consistent)."""
    errs: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    last_ts = -1.0
    for i, e in enumerate(events):
        missing = [
            k for k in ("name", "ph", "ts", "dur", "pid", "tid")
            if k not in e
        ]
        if missing:
            errs.append(f"event {i}: missing {missing}")
            continue
        if e["ph"] != "X":
            errs.append(f"event {i} ({e['name']}): ph={e['ph']!r}, not 'X'")
        if e["ts"] < 0 or e["dur"] < 0:
            errs.append(
                f"event {i} ({e['name']}): negative ts/dur "
                f"({e['ts']}, {e['dur']})"
            )
        if e["ts"] < last_ts:
            errs.append(f"event {i} ({e['name']}): ts not sorted")
        last_ts = e["ts"]
    other = doc.get("otherData") or {}
    if other.get("open_spans", 0) != 0:
        errs.append(f"{other['open_spans']} span(s) left open at export")
    for tenant, row in build_report(doc).items():
        total = sum(row[k] for k in _SHARE_KEYS)
        if abs(total - 100.0) > 0.1:
            errs.append(
                f"tenant {tenant!r}: shares sum to {total:.3f}, not 100"
            )
        if row["unattributed_pct"] > 0.1:
            errs.append(
                f"tenant {tenant!r}: {row['unattributed_pct']:.2f}% of the "
                "wall clock is blocked time with no attributable span"
            )
    return errs


def _fmt_table(rows: Dict[str, Dict[str, float]]) -> str:
    head = (
        f"{'tenant':<12} {'wall_s':>8} {'storage%':>9} {'cachefill%':>10} "
        f"{'transform%':>10} {'load%':>7} {'embed%':>7} {'compute%':>9} "
        f"{'unattr%':>8}"
    )
    lines = [head, "-" * len(head)]
    for tenant, r in rows.items():
        lines.append(
            f"{tenant or '(none)':<12} {r['wall_us'] / 1e6:>8.2f} "
            f"{r['storage_pct']:>9.2f} {r['cache_fill_pct']:>10.2f} "
            f"{r['transform_pct']:>10.2f} {r['load_pct']:>7.2f} "
            f"{r['embed_fetch_pct']:>7.2f} "
            f"{r['compute_pct']:>9.2f} {r['unattributed_pct']:>8.2f}"
        )
    head2 = (
        f"{'tenant':<12} {'storage_rx':>12} {'cache_rx':>12} "
        f"{'dram_res':>10} {'flash_res':>10} {'over_read':>9} {'fused':>6}"
    )
    lines += ["", head2, "-" * len(head2)]
    for tenant, r in rows.items():
        lines.append(
            f"{tenant or '(none)':<12} {int(r['storage_rx_bytes']):>12} "
            f"{int(r['cache_rx_bytes']):>12} "
            f"{int(r['dram_bytes_stored']):>10} "
            f"{int(r['flash_bytes_stored']):>10} "
            f"{r['over_read']:>9.2f} {r['fused_frac']:>6.2f}"
        )
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Table-7-style stall attribution from a trace artifact",
    )
    ap.add_argument("artifact", help="Chrome-trace JSON from Tracer.write")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON instead of a table")
    ap.add_argument("--check", action="store_true",
                    help="validate the artifact + accounting; exit 1 on "
                         "any violation")
    args = ap.parse_args(argv)
    with open(args.artifact, "r", encoding="utf-8") as f:
        doc = json.load(f)
    rows = build_report(doc)
    if args.json:
        print(json.dumps(rows, indent=2, sort_keys=True))
    else:
        print(_fmt_table(rows))
    if args.check:
        errs = check(doc)
        if errs:
            for e in errs:
                print(f"CHECK FAILED: {e}", file=sys.stderr)
            return 1
        print(f"report check: OK ({len(doc['traceEvents'])} events, "
              f"{len(rows)} row(s))")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
