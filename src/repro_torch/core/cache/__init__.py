from repro_torch.core.cache.dedup import CacheKey, DedupIndex, DedupStats, stripe_digest
from repro_torch.core.cache.stripe_cache import (
    ANON_TENANT,
    DRAM_TIER,
    FLASH_TIER,
    CacheLookup,
    StripeCache,
    TenantStats,
    TierStats,
    iops_per_watt,
)
from repro_torch.core.cache.tenancy import TenantPolicy, TenantShare
