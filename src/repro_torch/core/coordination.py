"""Coordinated-training simulator (§4): the collaborative release process.

Models hundreds of engineers iterating on a model via exploratory jobs,
periodic combo windows, and release candidates — producing the §4
characterization artifacts: job duration/status skew (Fig. 4), fleet
utilization peaks at combo windows (Fig. 5), per-model regional demand
(Fig. 6), and feature-lifecycle counts (Table 2 via ``TableSchema.evolve``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Job:
    kind: str                  # exploratory | combo | release_candidate
    model: str
    region: str
    start_day: float
    duration_days: float
    compute_units: float       # GPU-days/day while running
    status: str                # completed | killed | failed


@dataclasses.dataclass(frozen=True)
class ReleaseProcessConfig:
    n_models: int = 10
    n_regions: int = 5
    days: int = 365
    release_period_days: int = 30
    combo_window_days: int = 7
    exploratory_per_day: float = 12.0
    combo_jobs_per_release: int = 82           # Fig. 4's combo-job count
    rc_jobs_per_release: int = 4
    kill_rate: float = 0.35                    # lackluster jobs killed early
    fail_rate: float = 0.08
    seed: int = 0


def simulate(cfg: ReleaseProcessConfig) -> List[Job]:
    rng = np.random.default_rng(cfg.seed)
    models = [f"M{chr(ord('A') + i)}" for i in range(cfg.n_models)]
    regions = [f"R{i + 1}" for i in range(cfg.n_regions)]
    # each model prefers 1-2 regions (datasets co-located with trainers, §4.2)
    model_regions = {
        m: rng.choice(regions, size=rng.integers(1, 3), replace=False).tolist()
        for m in models
    }
    model_scale = {m: float(rng.pareto(1.1) + 0.3) for m in models}
    jobs: List[Job] = []

    def status():
        u = rng.random()
        if u < cfg.fail_rate:
            return "failed"
        if u < cfg.fail_rate + cfg.kill_rate:
            return "killed"
        return "completed"

    for m in models:
        scale = model_scale[m]
        for day in range(cfg.days):
            # exploratory: small, continuous
            n = rng.poisson(cfg.exploratory_per_day * scale / 3)
            for _ in range(n):
                st = status()
                full = float(rng.lognormal(0.2, 0.9))
                jobs.append(Job(
                    "exploratory", m, str(rng.choice(model_regions[m])),
                    day + rng.random(),
                    full * (rng.random() * 0.6 if st != "completed" else 1.0),
                    compute_units=0.2 * scale, status=st,
                ))
            # combo windows: many large concurrent jobs, temporally skewed
            phase = day % cfg.release_period_days
            if phase < cfg.combo_window_days:
                lam = cfg.combo_jobs_per_release * scale / cfg.combo_window_days / 3
                for _ in range(rng.poisson(lam)):
                    st = status()
                    full = float(rng.lognormal(1.6, 0.7))     # up to ~10+ days
                    jobs.append(Job(
                        "combo", m, str(rng.choice(model_regions[m])),
                        day + rng.random(),
                        full * (rng.random() * 0.5 if st != "completed" else 1.0),
                        compute_units=2.0 * scale, status=st,
                    ))
            # release candidates: few, large, on fresh data
            if phase == cfg.combo_window_days and rng.random() < 0.7:
                for _ in range(cfg.rc_jobs_per_release):
                    jobs.append(Job(
                        "release_candidate", m, str(rng.choice(model_regions[m])),
                        day + rng.random(), float(rng.lognormal(1.8, 0.4)),
                        compute_units=4.0 * scale, status="completed",
                    ))
    return jobs


def daily_utilization(jobs: List[Job], days: int) -> np.ndarray:
    """Fig. 5: total compute in flight per day."""
    util = np.zeros(days)
    for j in jobs:
        a = int(j.start_day)
        b = min(days, int(np.ceil(j.start_day + j.duration_days)))
        util[a:b] += j.compute_units
    return util


def regional_demand(jobs: List[Job]) -> Dict[str, Dict[str, float]]:
    """Fig. 6: per-model compute by region."""
    out: Dict[str, Dict[str, float]] = {}
    for j in jobs:
        out.setdefault(j.model, {})
        out[j.model][j.region] = out[j.model].get(j.region, 0.0) + (
            j.compute_units * j.duration_days
        )
    return out


def combo_duration_skew(jobs: List[Job]) -> Dict[str, float]:
    """Fig. 4: skewed durations + many killed/failed combo jobs."""
    durs = np.array([j.duration_days for j in jobs if j.kind == "combo"])
    statuses = [j.status for j in jobs if j.kind == "combo"]
    n = max(len(statuses), 1)
    return {
        "n_jobs": float(len(durs)),
        "p50_days": float(np.percentile(durs, 50)) if len(durs) else 0.0,
        "p95_days": float(np.percentile(durs, 95)) if len(durs) else 0.0,
        "max_days": float(durs.max()) if len(durs) else 0.0,
        "killed_frac": statuses.count("killed") / n,
        "failed_frac": statuses.count("failed") / n,
    }


def utilization_peak_to_mean(util: np.ndarray) -> float:
    return float(util.max() / max(util.mean(), 1e-9))
