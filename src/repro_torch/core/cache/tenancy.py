"""Multi-tenant capacity control for the shared stripe cache.

The §7.2 cache-tier argument only survives production if one misbehaving
job cannot wash the shared tier: a single antagonist scanning cold
partitions would otherwise evict every other job's working set (the
classic cache-pollution failure InTune, arXiv 2308.08500, attacks with
per-job resource allocation).  ``TenantPolicy`` gives each session/job a
configurable *guaranteed* fraction of each tier's capacity:

  * eviction prefers victims owned by tenants **over** their guarantee
    (in LRU order), so a tenant whose resident bytes fit its share is
    never evicted by someone else's traffic;
  * admission stays unconditional — **borrow-when-idle** semantics: a
    lone job fills the whole tier, and only loses its borrowed bytes
    (never its guaranteed ones) when other tenants need the space back.

Per-tenant ``TierStats`` charge every hit, byte, admission, and eviction
to the owning job, so capacity abuse is attributable and per-job hit
rates are directly reportable (``StripeCache.tenant_summary``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass
class TenantShare:
    """Guaranteed capacity fractions of the DRAM and flash tiers."""

    dram_frac: float = 0.0
    flash_frac: float = 0.0

    def frac(self, tier: str) -> float:
        return self.dram_frac if tier == "dram" else self.flash_frac


class TenantPolicy:
    """Per-tenant guaranteed capacity shares with borrow-when-idle.

    A tenant with no registered share has a guarantee of 0 bytes: it may
    still use the whole tier while idle capacity exists, but its entries
    are always the first eviction victims.  With no shares registered at
    all, eviction degenerates to plain LRU (every entry is over its
    0-byte guarantee) — the pre-tenancy behavior.
    """

    def __init__(self, shares: Optional[Dict[str, TenantShare]] = None):
        self.shares: Dict[str, TenantShare] = {}
        for tenant, share in (shares or {}).items():
            # route through set_share so the sum<=1.0 validation cannot be
            # bypassed by constructing the policy with an over-committed dict
            self.set_share(tenant, share.dram_frac, share.flash_frac)

    def set_share(
        self, tenant: str, dram_frac: float = 0.0, flash_frac: float = 0.0
    ) -> TenantShare:
        for name, frac in (("dram", dram_frac), ("flash", flash_frac)):
            total = frac + sum(
                s.frac(name) for t, s in self.shares.items() if t != tenant
            )
            if total > 1.0 + 1e-9:
                raise ValueError(
                    f"{name} shares would sum to {total:.3f} > 1.0 "
                    f"adding tenant {tenant!r}"
                )
        share = TenantShare(dram_frac, flash_frac)
        self.shares[tenant] = share
        return share

    def clear_share(self, tenant: str) -> None:
        """Release a tenant's reservation (its job ended): the guarantee
        lapses, so its resident bytes become ordinary borrowable LRU
        entries and its fraction is free for future tenants."""
        self.shares.pop(tenant, None)

    def frac(self, tenant: Optional[str], tier: str) -> float:
        share = self.shares.get(tenant)
        return share.frac(tier) if share is not None else 0.0

    def guaranteed_bytes(
        self, tenant: Optional[str], tier: str, capacity_bytes: int
    ) -> int:
        return int(self.frac(tenant, tier) * capacity_bytes)
