"""Content-addressed stripe identity (RecD-style dedup, arXiv 2211.05239).

Combo-window jobs re-read the same partitions, and warehouse re-ingestion /
table forks produce byte-identical stripes under *different* paths.  Keying
the cache by path would miss both; keying by **content** collapses them.

At warehouse-write time every encoded stripe payload is hashed and the
``(path, offset, length) -> digest`` mapping is registered here.  A read
extent that falls inside a registered stripe resolves to a content key
``(digest, rel_off, length)`` *without touching storage*, so the second
job (or the second byte-identical partition) hits the cache even though it
never read that path before.  Extents that cross stripe boundaries (e.g.
window-coalesced reads spanning stripes) fall back to a path-addressed key:
still cacheable, just not content-deduplicated.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

from repro_torch.obs import counter

# Cache key: ("c", digest, rel_off, length) for content-addressed extents,
# ("p", (path, generation), offset, length) for the path-addressed fallback.
# The generation is bumped on every invalidation (partition rewrite), so a
# key resolved *before* a rewrite can never collide with one resolved after
# it — an in-flight reader admitting pre-rewrite bytes under an old-gen key
# cannot be re-served to post-rewrite readers.  Content keys need no
# generation: the digest IS the bytes.
CacheKey = Tuple


def stripe_digest(payload: bytes) -> str:
    return hashlib.sha1(payload).hexdigest()


@dataclasses.dataclass
class _StripeSpan:
    offset: int
    length: int
    digest: str


@dataclasses.dataclass
class DedupStats:
    stripes_registered: int = counter()
    logical_bytes: int = counter()    # sum of registered stripe lengths
    unique_bytes: int = counter()     # sum over distinct digests

    @property
    def dedup_ratio(self) -> float:
        """Logical bytes per unique byte; 1.0 = no duplicates."""
        return self.logical_bytes / max(self.unique_bytes, 1)


class DedupIndex:
    """Maps file byte ranges to stripe content digests."""

    def __init__(self):
        self._spans: Dict[str, List[_StripeSpan]] = {}
        self._digest_bytes: Dict[str, int] = {}   # digest -> stripe length
        self._generation: Dict[str, int] = {}     # path -> rewrite count
        self.stats = DedupStats()

    def register(self, path: str, offset: int, length: int, payload: bytes) -> str:
        """Idempotent on (path, offset): re-attaching a cache that already
        indexed this file must not double-count the dedup statistics."""
        for span in self._spans.get(path, ()):
            if span.offset == offset:
                return span.digest
        d = stripe_digest(payload)
        self._spans.setdefault(path, []).append(_StripeSpan(offset, length, d))
        self.stats.stripes_registered += 1
        self.stats.logical_bytes += length
        if d not in self._digest_bytes:
            self._digest_bytes[d] = length
            self.stats.unique_bytes += length
        return d

    def invalidate(self, path: str) -> None:
        """Drop a path's spans and bump its generation (the file was
        rewritten, e.g. by append or partition churn): path keys resolved
        from now on cannot match anything admitted under the old bytes."""
        self._spans.pop(path, None)
        self._generation[path] = self._generation.get(path, 0) + 1

    def generation(self, path: str) -> int:
        return self._generation.get(path, 0)

    @property
    def unique_stripes(self) -> int:
        return len(self._digest_bytes)

    def resolve(self, path: str, offset: int, length: int) -> CacheKey:
        """Content key if [offset, offset+length) sits inside one registered
        stripe, else the path-addressed fallback key."""
        for span in self._spans.get(path, ()):
            if span.offset <= offset and offset + length <= span.offset + span.length:
                return ("c", span.digest, offset - span.offset, length)
        return ("p", (path, self._generation.get(path, 0)), offset, length)

    def segments(self, path: str, offset: int, length: int) -> List[Tuple[int, int]]:
        """Split [offset, offset+length) along registered stripe boundaries.

        Window-coalesced extents can span stripes; caching them whole would
        pin the cache to one job's coalescing pattern.  Cutting at stripe
        edges makes every cacheable unit resolve to a content key, so jobs
        with different windows/projections still share entries."""
        end = offset + length
        cur = offset
        out: List[Tuple[int, int]] = []
        for span in sorted(self._spans.get(path, ()), key=lambda s: s.offset):
            if span.offset + span.length <= cur or span.offset >= end:
                continue
            if cur < span.offset:               # unregistered gap before span
                out.append((cur, span.offset - cur))
                cur = span.offset
            seg_end = min(end, span.offset + span.length)
            out.append((cur, seg_end - cur))
            cur = seg_end
        if cur < end:
            out.append((cur, end - cur))
        return out
