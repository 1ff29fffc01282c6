"""Global training-job scheduler with dataset co-location (§7.3).

The paper observes that the current policy — balance each model's jobs
across all regions — forces every region to replicate every model's
dataset, and calls out the bin-packing opportunity: route jobs so each
dataset lives in few regions, subject to (a) regional compute capacity
covering the model's peak (combo-window) demand and (b) an availability
floor of >=2 regions per dataset.

``greedy_colocate`` implements that policy; ``replication_report``
quantifies storage saved vs replicate-everywhere, reproducing the §7.3
argument quantitatively.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ModelDemand:
    name: str
    dataset_pb: float
    mean_compute: float       # steady-state GPU units
    peak_compute: float       # combo-window peak (§4.2)


@dataclasses.dataclass
class Region:
    name: str
    capacity: float           # GPU units
    storage_pb: float


@dataclasses.dataclass
class Placement:
    model_regions: Dict[str, List[str]]
    region_load: Dict[str, float]        # mean-compute load
    region_peak: Dict[str, float]

    def replicas(self, model: str) -> int:
        return len(self.model_regions[model])


def replicate_everywhere(models: List[ModelDemand], regions: List[Region]) -> Placement:
    """The paper's current policy (Fig. 6): every region holds every dataset."""
    names = [r.name for r in regions]
    load = {r.name: 0.0 for r in regions}
    peak = {r.name: 0.0 for r in regions}
    for m in models:
        for r in regions:
            load[r.name] += m.mean_compute / len(regions)
            peak[r.name] += m.peak_compute / len(regions)
    return Placement({m.name: list(names) for m in models}, load, peak)


def greedy_colocate(
    models: List[ModelDemand],
    regions: List[Region],
    min_replicas: int = 2,
    headroom: float = 0.9,
) -> Placement:
    """Bin-pack models into the fewest regions whose remaining capacity
    covers the model's peak; large models are placed first."""
    placement: Dict[str, List[str]] = {}
    peak = {r.name: 0.0 for r in regions}
    load = {r.name: 0.0 for r in regions}
    cap = {r.name: r.capacity for r in regions}

    for m in sorted(models, key=lambda m: -m.peak_compute):
        chosen: List[str] = []
        # a model may need several regions if its peak exceeds one region
        needed_peak = m.peak_compute
        candidates = sorted(regions, key=lambda r: peak[r.name])
        for r in candidates:
            if len(chosen) >= min_replicas and needed_peak <= 0:
                break
            room = cap[r.name] * headroom - peak[r.name]
            if room <= 0 and needed_peak > 0:
                continue
            take = min(max(room, 0.0), needed_peak) if needed_peak > 0 else 0.0
            chosen.append(r.name)
            peak[r.name] += take
            needed_peak -= take
        # availability floor
        for r in candidates:
            if len(chosen) >= min_replicas:
                break
            if r.name not in chosen:
                chosen.append(r.name)
        share = 1.0 / len(chosen)
        for name in chosen:
            load[name] += m.mean_compute * share
        placement[m.name] = chosen
    return Placement(placement, load, peak)


def replication_report(
    models: List[ModelDemand], baseline: Placement, packed: Placement
) -> Dict[str, float]:
    base_pb = sum(m.dataset_pb * baseline.replicas(m.name) for m in models)
    packed_pb = sum(m.dataset_pb * packed.replicas(m.name) for m in models)
    return {
        "baseline_storage_pb": base_pb,
        "packed_storage_pb": packed_pb,
        "storage_saved_frac": 1.0 - packed_pb / max(base_pb, 1e-9),
        "max_region_peak_baseline": max(baseline.region_peak.values()),
        "max_region_peak_packed": max(packed.region_peak.values()),
    }


def demands_from_release_sim(jobs, dataset_pb: Dict[str, float]) -> List[ModelDemand]:
    """Build per-model demand profiles from the §4 coordination simulator."""
    from repro_torch.core.coordination import daily_utilization

    by_model: Dict[str, List] = {}
    for j in jobs:
        by_model.setdefault(j.model, []).append(j)
    out = []
    for model, js in by_model.items():
        days = int(max(j.start_day + j.duration_days for j in js)) + 1
        util = daily_utilization(js, days)
        out.append(
            ModelDemand(
                name=model,
                dataset_pb=dataset_pb.get(model, 1.0),
                mean_compute=float(util.mean()),
                peak_compute=float(util.max()),
            )
        )
    return out
