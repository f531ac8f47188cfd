"""Control-plane sharding: stable routing ids + per-shard config carving.

A copy of the JAX package's ``runtime/sharding.py`` (framework-free): the
port's shards, front ends and clients mint and parse the same ids.

The single-coordinator control plane tops out around 8 jobs/s on the dev
box (benchmarks/loadtest_single_shard.json) because one Python process
owns every session, job, placement, and SSE stream. The sharded topology
(docs/ARCHITECTURE.md "Sharded control plane") splits that into:

- N **coordinator shards** — full Coordinator+ClusterRuntime processes,
  each owning the sessions that hash to it, its own ``JobStore`` journal
  (``<journal_dir>/shard-<k>``), its own placement engine, and its own
  worker partition;
- any number of stateless **front ends** (runtime/frontend.py) that route
  requests to shards using only the ids in the URL — no lookup table, no
  shared state, so front ends scale horizontally and restart freely.

Three id conventions make stateless routing possible:

- ``shard_of(session_id, n)`` — a stable content hash (sha1, NOT Python's
  salted ``hash()``) of the session id. Every front end, in every process,
  forever, maps a session to the same shard. Sessions are minted BY the
  front end so the hash and the owning shard agree by construction.
- **job ids carry a shard stamp**: the owning shard prefixes every job id
  with ``s<k>-`` (``stamp_job_id``), so job-only routes (``/trace/<jid>``,
  ``/cost/<jid>``, ``/explain/<jid>``) route without knowing the session.
  Client-minted job ids (idempotent resubmits) are stamped the same
  deterministic way, so the dedupe contract survives sharding.
- **worker ids carry the same stamp**: a shard's placement engine mints
  ``s<k>-worker-<n>`` ids, so every worker-plane route
  (``/next_tasks/<wid>``, ``/task_result/<wid>``, ...) routes by prefix.

Uuid4-style ids can never be mistaken for stamps (a uuid's first dash is
at position 8; the stamp's is at position 3), so unstamped single-shard
deployments parse as "no shard" and behave exactly as before.
"""

from __future__ import annotations

import hashlib
import re
import threading
import time
from typing import Optional

#: stamp grammar shared by job and worker ids: ``s<2-digit shard>-<rest>``
#: — two digits exactly, hence the MAX_SHARDS=100 bound (a 3-digit index
#: would mint ids the parser, and therefore every front end, rejects)
_STAMP_RE = re.compile(r"^s(\d{2})-")

#: hard bound implied by the 2-digit stamp grammar; enforced at mint
#: time and by the launch surfaces (server --num-shards, ShardFleet)
MAX_SHARDS = 100


def shard_of(session_id: str, n_shards: int) -> int:
    """Stable shard index for a session id. sha1-based so the mapping is
    identical across processes and Python restarts (``hash()`` is salted
    per process and would scatter a session over the fleet)."""
    if n_shards <= 1:
        return 0
    digest = hashlib.sha1(str(session_id).encode()).digest()
    return int.from_bytes(digest[:8], "big") % n_shards


def stamp_job_id(shard_id: int, job_id: str) -> str:
    """Prefix a job id with its OWNING shard. Deterministic — the same
    client-minted id always stamps to the same canonical id, so
    duplicate submits dedupe across retries exactly as unsharded ones —
    and idempotent only for this shard's own stamp: a client-minted id
    that happens to carry a FOREIGN-looking stamp (``s07-retrain`` as an
    idempotency key submitted to shard 2) is wrapped again, because
    passing it through would bind the job to a shard that never stored
    it and job-only routes would 404 instead of scatter-probing."""
    if not 0 <= int(shard_id) < MAX_SHARDS:
        raise ValueError(
            f"shard_id {shard_id} outside the stamp grammar "
            f"[0, {MAX_SHARDS})"
        )
    if id_shard(job_id) == int(shard_id):
        return job_id
    return f"s{shard_id:02d}-{job_id}"


def id_shard(stamped_id: str) -> Optional[int]:
    """Shard index carried by a stamped job/worker id, or None for
    unstamped (single-shard / client-minted) ids."""
    m = _STAMP_RE.match(str(stamped_id))
    return int(m.group(1)) if m else None


def worker_prefix(shard_id: int) -> str:
    """Worker-id prefix a shard's placement engine mints under, so every
    worker route is front-end-routable by the same stamp grammar."""
    if not 0 <= int(shard_id) < MAX_SHARDS:
        raise ValueError(
            f"shard_id {shard_id} outside the stamp grammar "
            f"[0, {MAX_SHARDS})"
        )
    return f"s{shard_id:02d}-"


def _carve(cap: int, n_shards: int) -> int:
    """One shard's share of a global admission cap: floor division so
    the shares sum to AT MOST the global cap (caps are upper bounds —
    rejecting a touch early under hash imbalance is the safe side;
    ceil would over-admit up to N-1 jobs past the configured total).
    Floored at 1 because 0 means "cap disabled" in the admission logic —
    so a cap smaller than the shard count admits up to N (one per
    shard), the closest enforceable bound."""
    return max(cap // n_shards, 1)


def shard_service_config(cfg, n_shards: int):
    """Per-shard copy of a FrameworkConfig with the GLOBAL admission caps
    carved into per-shard shares (``_carve``: floor, min 1), so the
    fleet-wide accepted load stays bounded by the configured totals (not
    cap x N — pinned in tests/test_sharding.py). The per-SESSION cap is
    untouched — a session lives entirely on one shard."""
    if n_shards <= 1:
        return cfg
    svc = cfg.service
    updates = {}
    if svc.max_inflight_jobs > 0:
        updates["max_inflight_jobs"] = _carve(
            svc.max_inflight_jobs, n_shards
        )
    if svc.admission_queue_watermark > 0:
        updates["admission_queue_watermark"] = _carve(
            svc.admission_queue_watermark, n_shards
        )
    if not updates:
        return cfg
    return cfg.merged({"service": updates})


class ForwardingCache:
    """Bounded-TTL job→shard redirect cache for migrated jobs.

    When a job migrates (docs/ROBUSTNESS.md "Shard rebalancing") the
    donor shard answers its job routes with ``409 {"status": "moved",
    "migrated_to": k}`` — the forwarding stamp. Without a cache every
    request for a migrated job pays a probe-then-redirect round trip;
    with it the front end proxies straight to the new owner until the
    entry expires. TTL-bounded (not permanent) because a stamp can go
    stale — the job may migrate again, or the fleet may be redeployed
    with a different shard count — and a bounded re-probe beats serving
    a wrong shard forever. Entry count is bounded so a scan over many
    dead job ids cannot grow front-end memory without limit."""

    def __init__(self, ttl_s: float = 300.0, max_entries: int = 4096):
        self.ttl_s = float(ttl_s)
        self.max_entries = int(max_entries)
        self._lock = threading.Lock()
        self._entries: dict = {}  # job_id -> (shard, expires_at)

    def get(self, job_id: str) -> Optional[int]:
        """Cached destination shard for a job id, or None (unknown or
        expired — expired entries are dropped on read)."""
        with self._lock:
            hit = self._entries.get(job_id)
            if hit is None:
                return None
            shard, expires = hit
            if time.time() >= expires:
                self._entries.pop(job_id, None)
                return None
            return shard

    def put(self, job_id: str, shard: int) -> None:
        with self._lock:
            if job_id not in self._entries and len(self._entries) >= self.max_entries:
                now = time.time()
                expired = [j for j, (_, exp) in self._entries.items() if now >= exp]
                for j in expired:
                    self._entries.pop(j, None)
                if len(self._entries) >= self.max_entries:
                    # still full: evict the soonest-to-expire entry —
                    # O(n), but only on the overflow path
                    oldest = min(self._entries, key=lambda j: self._entries[j][1])
                    self._entries.pop(oldest, None)
            self._entries[job_id] = (int(shard), time.time() + self.ttl_s)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
