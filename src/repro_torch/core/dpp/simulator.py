"""Analytic DSI fleet simulator (§6, §7.1, Fig. 1/8/9, Tables 8-10).

Scales the byte/cycle coefficients measured from this repo's CPU
implementation (and the paper's published ratios) to fleet-sized hardware:
given a node spec (Table 10) and a model's preprocessing workload, compute
achievable DPP-worker throughput and its binding resource; given trainer
ingest demand (Table 8), compute workers-per-trainer, trainer frontend
utilization (Fig. 8), and the storage/preprocessing/training power split
(Fig. 1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """Table 10."""
    name: str
    cores: int
    nic_gbps: float
    memory_gb: float
    mem_bw_gbps: float        # GB/s

    @property
    def mem_bw_per_core(self) -> float:
        return self.mem_bw_gbps / self.cores

    @property
    def nic_bw_per_core_gbps(self) -> float:
        return self.nic_gbps / self.cores


C_V1 = NodeSpec("C-v1", cores=18, nic_gbps=12.5, memory_gb=64, mem_bw_gbps=75)
C_V2 = NodeSpec("C-v2", cores=26, nic_gbps=25.0, memory_gb=64, mem_bw_gbps=92)
C_V3 = NodeSpec("C-v3", cores=36, nic_gbps=25.0, memory_gb=64, mem_bw_gbps=83)
C_SOTA = NodeSpec("C-vSotA", cores=64, nic_gbps=100.0, memory_gb=1024, mem_bw_gbps=205)
NODE_SPECS = {n.name: n for n in (C_V1, C_V2, C_V3, C_SOTA)}


@dataclasses.dataclass(frozen=True)
class ModelWorkload:
    """Per-sample preprocessing coefficients for one RM (calibrated to
    reproduce Table 9 on C-v1).

    ``*_cyc_per_byte`` are CPU cycles per byte of the respective phase input;
    ``mem_traffic_x`` is DRAM bytes moved per byte processed (format
    conversions, copies, TLS ~3x amplification — §6.2/§7.2).
    """
    name: str
    sample_bytes_storage: float       # compressed bytes read per sample
    sample_bytes_raw: float           # decoded bytes per sample (transform RX)
    sample_bytes_tensor: float        # materialized tensor bytes (TX)
    extract_cyc_per_byte: float
    transform_cyc_per_byte: float
    mem_traffic_x: float
    trainer_gbps: float               # Table 8 demand per 8-GPU node (GB/s)
    mem_capacity_per_kqps_gb: float = 0.5

    @property
    def kqps_ratio(self) -> float:
        return 1.0


# Calibrated so C-v1 reproduces Table 9 (kQPS, RX/TX, workers per trainer).
# mem_traffic_x calibrated from Fig. 9 memBW utilization at saturation
# (LLC-miss traffic: transforms 50.4%, extraction 24.9%, net 21.1% — §6.3);
# cycle coefficients calibrated to Table 9 kQPS on C-v1.
RM1 = ModelWorkload(
    "RM1", sample_bytes_storage=0.8e9 / 11623e0, sample_bytes_raw=1.37e9 / 11623,
    sample_bytes_tensor=0.68e9 / 11623,
    extract_cyc_per_byte=8.0, transform_cyc_per_byte=24.9, mem_traffic_x=52.0,
    trainer_gbps=16.50,
)
RM2 = ModelWorkload(
    "RM2", sample_bytes_storage=1.2e9 / 7995, sample_bytes_raw=0.96e9 / 7995,
    sample_bytes_tensor=0.50e9 / 7995,
    extract_cyc_per_byte=10.0, transform_cyc_per_byte=18.0, mem_traffic_x=54.0,
    trainer_gbps=4.69,
)
RM3 = ModelWorkload(
    "RM3", sample_bytes_storage=0.8e9 / 36921, sample_bytes_raw=1.01e9 / 36921,
    sample_bytes_tensor=0.22e9 / 36921,
    extract_cyc_per_byte=6.0, transform_cyc_per_byte=9.0, mem_traffic_x=37.0,
    trainer_gbps=12.00, mem_capacity_per_kqps_gb=1.73,
)
WORKLOADS = {"RM1": RM1, "RM2": RM2, "RM3": RM3}

CPU_GHZ = 2.5


@dataclasses.dataclass
class WorkerThroughput:
    kqps: float
    bound: str
    storage_rx_gbps: float
    transform_rx_gbps: float
    tx_gbps: float
    utilization: Dict[str, float]


def worker_throughput(w: ModelWorkload, node: NodeSpec) -> WorkerThroughput:
    """Max sustainable samples/s for one DPP worker on ``node`` and which
    resource binds (§6.3)."""
    cyc_per_sample = (
        w.sample_bytes_raw * w.extract_cyc_per_byte
        + w.sample_bytes_raw * w.transform_cyc_per_byte
    )
    cpu_qps = node.cores * CPU_GHZ * 1e9 / cyc_per_sample

    # full-duplex NIC at ~80% practical line rate (paper: ~10 of 12.5 Gbps)
    practical = 0.8 * node.nic_gbps / 8 * 1e9
    nic_in_qps = practical / w.sample_bytes_storage
    nic_out_qps = practical / w.sample_bytes_tensor
    nic_qps = min(nic_in_qps, nic_out_qps)

    membw_qps = node.mem_bw_gbps * 1e9 / (w.sample_bytes_raw * w.mem_traffic_x)
    memcap_qps = node.memory_gb / w.mem_capacity_per_kqps_gb * 1e3

    candidates = {
        "cpu": cpu_qps, "nic": nic_qps,
        "mem_bw": membw_qps, "mem_capacity": memcap_qps,
    }
    bound = min(candidates, key=candidates.get)
    qps = candidates[bound]
    return WorkerThroughput(
        kqps=qps / 1e3,
        bound=bound,
        storage_rx_gbps=qps * w.sample_bytes_storage / 1e9,
        transform_rx_gbps=qps * w.sample_bytes_raw / 1e9,
        tx_gbps=qps * w.sample_bytes_tensor / 1e9,
        utilization={k: qps / v for k, v in candidates.items()},
    )


def workers_per_trainer(w: ModelWorkload, node: NodeSpec) -> float:
    """Table 9 rightmost column: workers to feed one 8-GPU trainer node."""
    wt = worker_throughput(w, node)
    return w.trainer_gbps / max(wt.tx_gbps, 1e-9)


def split_over_read_amplification(
    partition_rows: int,
    rows_per_split: int,
    stripe_rows: int,
    split_scoped: bool = True,
    stripe_aligned: bool = True,
) -> float:
    """Rows decoded per row served across one partition's splits.

    ``split_scoped=False`` models a read path where every split re-reads
    and decodes the whole partition: amplification equals the number of
    splits per partition, so adding workers multiplies wasted bytes.
    Split-scoped reads only pay stripe-edge trim waste, and stripe-aligned
    splits eliminate even that (amplification 1.0).
    """
    partition_rows = max(1, partition_rows)
    n_splits = -(-partition_rows // max(1, rows_per_split))
    if not split_scoped:
        return float(n_splits)
    if stripe_aligned or stripe_rows <= 0:
        return 1.0
    decoded = 0
    for s in range(n_splits):
        lo = s * rows_per_split
        hi = min(partition_rows, lo + rows_per_split)
        first = (lo // stripe_rows) * stripe_rows
        last = min(partition_rows, -(-hi // stripe_rows) * stripe_rows)
        decoded += last - first
    return decoded / partition_rows


# ---------------------------------------------------------------------------
# Trainer frontend model (Fig. 8, Table 7)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainerFrontend:
    """2-socket trainer host frontend (§6.2)."""
    cores: int = 56
    nic_gbps: float = 200.0          # 2 x 100G frontend NICs
    mem_bw_gbps: float = 150.0
    # datacenter tax: cycles and DRAM bytes per ingested byte
    load_cyc_per_byte: float = 6.0   # TLS + thrift + memcpy + net stack
    mem_traffic_x: float = 4.0


def trainer_loading_utilization(
    gbps: float, fe: TrainerFrontend = TrainerFrontend()
) -> Dict[str, float]:
    """CPU / memBW / NIC utilization at a given ingest rate (Fig. 8)."""
    cyc = gbps * 1e9 * fe.load_cyc_per_byte
    return {
        "cpu": cyc / (fe.cores * CPU_GHZ * 1e9),
        "mem_bw": gbps * fe.mem_traffic_x / fe.mem_bw_gbps,
        "nic": gbps * 8 / fe.nic_gbps,
    }


def colocated_preprocessing_stall(
    w: ModelWorkload,
    fe: TrainerFrontend = TrainerFrontend(),
    demand_scale: float = 0.19,      # Table 7 used a V100-era 8-GPU node
) -> Dict[str, float]:
    """Table 7: run extract+transform on the trainer host itself and compute
    the resulting GPU stall fraction."""
    demand_qps = demand_scale * w.trainer_gbps * 1e9 / w.sample_bytes_tensor
    cyc_per_sample = w.sample_bytes_raw * (
        w.extract_cyc_per_byte + w.transform_cyc_per_byte
    ) + w.sample_bytes_tensor * fe.load_cyc_per_byte
    cpu_qps = fe.cores * CPU_GHZ * 1e9 / cyc_per_sample
    membw_qps = fe.mem_bw_gbps * 1e9 / (
        w.sample_bytes_raw * w.mem_traffic_x + w.sample_bytes_tensor * fe.mem_traffic_x
    )
    achievable = min(cpu_qps, membw_qps)
    stall = max(0.0, 1.0 - achievable / demand_qps)
    return {
        "gpu_stall_frac": stall,
        "cpu_util": min(1.0, demand_qps / cpu_qps),
        "mem_bw_util": min(1.0, demand_qps / membw_qps),
    }


# ---------------------------------------------------------------------------
# Power model (Fig. 1, §7.5)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PowerSpec:
    trainer_node_W: float = 6500.0        # 8-GPU ZionEX-class node
    dpp_node_W: float = 350.0
    storage_node_W: float = 450.0
    storage_node_MBps: float = 1500.0     # ~30-disk HDD node at coalesced DSI I/O sizes


@dataclasses.dataclass(frozen=True)
class CacheTierSpec:
    """A shared DRAM/flash cache tier in front of the HDD fleet (§7.2).

    ``hit_frac`` is the fraction of storage-read **bytes** the tier absorbs
    — feed it a byte-weighted measurement such as
    ``WorkerMetrics.cache_served_frac``, not the request-count
    ``StripeCache.hit_rate`` (sub-range hits and whole-stripe misses have
    very different sizes).  Cache nodes serve far more MB/s per watt than
    HDD storage nodes, which is where the IOPS/W win comes from.
    """
    hit_frac: float
    tier_node_W: float = 75.0             # flash cache node (NVMe + host share)
    tier_node_MBps: float = 6000.0


def dsi_power_split(
    w: ModelWorkload,
    n_trainers: int,
    node: NodeSpec = C_V1,
    power: PowerSpec = PowerSpec(),
    storage_amplification: float = 1.0,   # over-read already in byte ratios
    cache: Optional[CacheTierSpec] = None,
) -> Dict[str, float]:
    """Fig. 1: storage/preprocessing/training power split for one job.
    With a ``CacheTierSpec``, the hit fraction of read traffic moves from
    HDD storage nodes to (cheaper-per-byte-served) cache-tier nodes."""
    n_workers = workers_per_trainer(w, node) * n_trainers
    storage_MBps = w.trainer_gbps * 1e3 * n_trainers * (
        w.sample_bytes_storage / w.sample_bytes_tensor
    ) * storage_amplification
    cache_MBps = 0.0
    if cache is not None:
        cache_MBps = storage_MBps * cache.hit_frac
        storage_MBps -= cache_MBps
    n_storage = storage_MBps / power.storage_node_MBps
    p = {
        "training_W": n_trainers * power.trainer_node_W,
        "preprocessing_W": n_workers * power.dpp_node_W,
        "storage_W": n_storage * power.storage_node_W,
    }
    if cache is not None:
        p["cache_W"] = cache_MBps / cache.tier_node_MBps * cache.tier_node_W
    total = sum(p.values())
    p.update({k.replace("_W", "_frac"): v / total for k, v in list(p.items())})
    return p
