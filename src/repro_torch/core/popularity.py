"""Feature/byte popularity tracking across training jobs (Fig. 7, §5.2).

Records which features (and how many bytes) each training job reads; from
this we derive the popularity CDF (x% most popular bytes -> y% of traffic)
and the feature order used by the feature-reordering writer optimization.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class PopularityTracker:
    read_bytes_by_feature: Dict[int, float] = dataclasses.field(default_factory=dict)
    read_count_by_feature: Dict[int, int] = dataclasses.field(default_factory=dict)
    total_reads: int = 0

    def record_job(self, feature_bytes: Dict[int, float]) -> None:
        self.total_reads += 1
        for fid, nb in feature_bytes.items():
            self.read_bytes_by_feature[fid] = self.read_bytes_by_feature.get(fid, 0.0) + nb
            self.read_count_by_feature[fid] = self.read_count_by_feature.get(fid, 0) + 1

    def feature_order(self) -> List[int]:
        """Most-popular-first order (the FR writer input)."""
        return [
            fid for fid, _ in sorted(
                self.read_bytes_by_feature.items(), key=lambda kv: -kv[1]
            )
        ]

    def popularity_cdf(
        self, stored_bytes_by_feature: Dict[int, float]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Fig. 7: x = CDF of stored bytes (most popular first), y = CDF of
        read traffic those bytes absorb."""
        feats = sorted(
            stored_bytes_by_feature,
            key=lambda f: -(self.read_bytes_by_feature.get(f, 0.0)
                            / max(stored_bytes_by_feature[f], 1.0)),
        )
        stored = np.array([stored_bytes_by_feature[f] for f in feats], np.float64)
        traffic = np.array(
            [self.read_bytes_by_feature.get(f, 0.0) for f in feats], np.float64
        )
        x = np.cumsum(stored) / max(stored.sum(), 1.0)
        y = np.cumsum(traffic) / max(traffic.sum(), 1.0)
        return x, y

    def bytes_fraction_for_traffic(
        self, stored_bytes_by_feature: Dict[int, float], traffic_frac: float = 0.8
    ) -> float:
        """Fraction of stored bytes needed to serve ``traffic_frac`` of reads
        (paper: 18-39% of bytes serve 80% of traffic)."""
        x, y = self.popularity_cdf(stored_bytes_by_feature)
        idx = int(np.searchsorted(y, traffic_frac))
        return float(x[min(idx, len(x) - 1)])
