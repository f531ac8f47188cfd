"""Multi-tenant staged-dataset cache: one device copy per (dataset, device).

Port of the JAX package's ``data/stage_cache.py``, holding torch tensors
(CUDA tensors on the card). The trial engine (parallel/trial_map.py)
stages every job-invariant tensor through it — the dataset (raw or its
prepared forms), the fold tensors, the packed LogReg path's padded bf16
design matrix and per-split Lipschitz bound, and the streamed row blocks
(data/streaming.py) — so the jobs of a process share one upload:

- **content-fingerprint keys**: every entry is keyed by a sha1 over the
  dataset's bytes + shape/dtype + ``n_classes`` + an optional
  ``preprocess_salt`` attribute, plus the device's identity and the
  caller's entry subkey (prepared-form salt, fold signature). Two
  TrialData objects with identical content share one device copy; a CPU
  tensor never serves a CUDA run, or the reverse.
- **single-flight staging**: concurrent misses on one key perform exactly
  ONE upload; later arrivals wait on the maker's event and reuse its
  entry. A failed make releases the waiters (the next becomes the maker).
- **refcounted LRU under a device-memory budget**: runs pin the entries
  they touch (``pin_begin``/``pin_end``) and the streamer holds explicit
  refs (``acquire``/``release``) on its in-flight blocks; eviction walks
  LRU order, skips pinned entries, and stops at ``budget_bytes()``.
- **observability**: ``tpuml_stage_cache_{hits,misses,uploads,evictions,
  tunnel_bytes,overflow}_total`` counters through the port's
  ``obs.counter_inc``, and ``stage.upload`` / ``stage.evict`` /
  ``stage.overflow`` flight-recorder events. The byte and entry gauges
  wait for the port's gauges (ROADMAP A4).

Valves (the JAX package's names): ``CS230_STAGE_CACHE=0`` bypasses the
module (the engine stages per call, as before the cache),
``CS230_STAGE_CACHE_MB`` pins the budget, ``CS230_STAGE_STRICT=1`` turns
an entry over the budget into :class:`StageBudgetExceeded`. The mesh
forms (a replicated or row-sharded entry built device to device) come
with multi-device (ROADMAP A3); ``transport`` keeps only its
single-device meaning, a host-to-device upload.
"""

from __future__ import annotations

import collections
import hashlib
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..obs import counter_inc, record_event
from ..utils.logging import get_logger

logger = get_logger("tpuml.stagecache")


def enabled() -> bool:
    """CS230_STAGE_CACHE=0 restores per-call staging (the parity valve).
    Read per call so tests can flip it live."""
    return os.environ.get("CS230_STAGE_CACHE", "1") != "0"


def strict_enabled() -> bool:
    """CS230_STAGE_STRICT=1 turns the stage budget from advisory into a
    hard ceiling: one upload larger than ``budget_bytes()`` raises
    :class:`StageBudgetExceeded` instead of staging anyway — the failure a
    dataset over the card's memory meets, made deterministic at any
    budget (and on the CPU)."""
    return os.environ.get("CS230_STAGE_STRICT", "0") == "1"


class StageBudgetExceeded(RuntimeError):
    """A single staged entry exceeds the stage-cache budget under
    ``CS230_STAGE_STRICT=1``."""


def budget_bytes() -> int:
    """Device-memory budget for staged entries: ``CS230_STAGE_CACHE_MB``
    when set, else 40% of the card's total memory, else (no CUDA) the
    JAX package's 8 GB assumption."""
    env = os.environ.get("CS230_STAGE_CACHE_MB")
    if env:
        try:
            return max(int(float(env) * 1e6), 1)
        except ValueError:
            pass
    import torch

    if torch.cuda.is_available():
        dev = torch.cuda.current_device()
        return int(0.4 * torch.cuda.get_device_properties(dev).total_memory)
    return int(0.4 * 8e9)


def dataset_fingerprint(data) -> str:
    """Content fingerprint of a TrialData: sha1 over the dataset bytes,
    shape/dtype signature, n_classes and the optional ``preprocess_salt``
    attribute. Cached on the TrialData object: the hash walks every byte
    once (~0.05 s for the 25 MB covertype matrix)."""
    fp = getattr(data, "_content_fp", None)
    if fp is not None:
        return fp
    h = hashlib.sha1()
    X = data.X
    leaves = [X[k] for k in sorted(X)] if isinstance(X, dict) else [X]
    for leaf in leaves:
        a = np.ascontiguousarray(np.asarray(leaf))
        h.update(repr((a.shape, str(a.dtype))).encode())
        h.update(a.tobytes())
    y = np.ascontiguousarray(np.asarray(data.y))
    h.update(repr((y.shape, str(y.dtype), int(getattr(data, "n_classes", 0)))).encode())
    h.update(y.tobytes())
    h.update(str(getattr(data, "preprocess_salt", "")).encode())
    fp = h.hexdigest()
    try:
        object.__setattr__(data, "_content_fp", fp)
    except Exception:  # noqa: BLE001 — exotic TrialData subclass: recompute
        pass
    return fp


def host_signature(device=None) -> tuple:
    """Host identity for the streamed block keys: (device type, rank).
    The rank stays 0 until multi-device brings ``torch.distributed``
    (ROADMAP A3)."""
    return (getattr(device, "type", None) or "cpu", 0)


def _tree_nbytes(value: Any) -> int:
    """Bytes of the tensors and arrays in nested dicts, lists and tuples
    (a tensor counts ``numel() * element_size()``)."""
    if isinstance(value, dict):
        return sum(_tree_nbytes(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return sum(_tree_nbytes(v) for v in value)
    numel = getattr(value, "numel", None)
    if callable(numel) and hasattr(value, "element_size"):
        return int(numel()) * int(value.element_size())
    nbytes = getattr(value, "nbytes", None)
    return int(nbytes) if nbytes is not None else 0


class _Entry:
    __slots__ = ("value", "nbytes", "refs")

    def __init__(self, value: Any, nbytes: int):
        self.value = value
        self.nbytes = nbytes
        #: live pins from in-flight runs and streamers — never evicted while > 0
        self.refs = 0


class StagedDatasetCache:
    """Process-global refcounted LRU of device-resident staged tensors.

    Keys are opaque tuples built by the trial engine:
    ``(dataset_fingerprint, device_signature, *entry_subkey)``. Values are
    whatever the staging ``make()`` returned (tensors or dicts of them).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[Any, _Entry]" = collections.OrderedDict()
        #: key -> Event for a staging upload currently in flight
        self._inflight: Dict[Any, threading.Event] = {}
        self._bytes = 0
        self._local = threading.local()
        self._stats = {"hits": 0, "misses": 0, "uploads": 0, "evictions": 0,
                       "unevictable_overflows": 0, "tunnel_bytes": 0}
        #: per-key upload counts: the one-upload-per-(dataset, device) observable
        self._uploads_by_key: collections.Counter = collections.Counter()

    # ---------------- pin scopes (refcounting) ----------------
    #
    # A run (trial_map.run_trials) opens a pin scope; every entry it
    # touches gains one ref for the scope's lifetime, so eviction under
    # memory pressure never drops a tensor out from under a dispatch.
    # Scopes are per thread and nest (each coordinator job thread runs its
    # own).

    def pin_begin(self) -> int:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        stack.append(set())
        return len(stack)

    def pin_end(self, token: int) -> None:
        stack = getattr(self._local, "stack", None)
        if not stack:
            return
        pinned = stack.pop()
        with self._lock:
            for key in pinned:
                entry = self._entries.get(key)
                if entry is not None:
                    entry.refs = max(0, entry.refs - 1)

    def _pin_locked(self, key: Any) -> None:
        stack = getattr(self._local, "stack", None)
        if not stack:
            return
        scope = stack[-1]
        if key not in scope:
            scope.add(key)
            entry = self._entries.get(key)
            if entry is not None:
                entry.refs += 1

    # ---------------- explicit refs (cross-thread pins) ----------------
    #
    # Pin scopes are thread-local; the streamer's prefetch worker stages
    # block i+1 on another thread than the one consuming block i, so it
    # takes an explicit ref that release() drops from ANY thread.

    def acquire(self, key: Any, make: Callable[[], Any], *,
                transport: str = "tunnel") -> Tuple[Any, str]:
        """``get_or_stage`` plus one explicit ref on the entry, which stays
        out of the calling thread's pin scope: a streamed block is held
        only while its pass needs it, whichever thread stages it. If the
        entry was evicted between the stage returning and the ref landing,
        it is staged again: the ref is only ever taken on a live entry
        holding the value handed out."""
        while True:
            value, outcome = self._stage(key, make, transport, pin=False)
            with self._lock:
                entry = self._entries.get(key)
                if entry is not None and entry.value is value:
                    entry.refs += 1
                    return value, outcome

    def release(self, key: Any) -> None:
        """Drop one explicit ref taken by :meth:`acquire`."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                entry.refs = max(0, entry.refs - 1)

    # ---------------- lookup / staging ----------------

    def get_or_stage(self, key: Any, make: Callable[[], Any], *,
                     transport: str = "tunnel") -> Tuple[Any, str]:
        """Return ``(value, outcome)`` where outcome is ``"hit"`` (cached),
        ``"wait"`` (another thread staged it while this one waited) or
        ``"miss"`` (this caller ran ``make()``, a host-to-device upload).
        Exactly one concurrent caller per key runs ``make()``; a failed
        make releases the waiters to retry. The entry joins the calling
        thread's pin scope, if one is open."""
        return self._stage(key, make, transport, pin=True)

    def _stage(self, key: Any, make: Callable[[], Any], transport: str,
               pin: bool) -> Tuple[Any, str]:
        if transport != "tunnel":
            raise ValueError(f"transport {transport!r}: only host-to-device "
                             "uploads ('tunnel') are ported")
        waited = False
        while True:
            with self._lock:
                entry = self._entries.get(key)
                if entry is not None:
                    self._entries.move_to_end(key)
                    self._stats["hits"] += 1
                    if pin:
                        self._pin_locked(key)
                    counter_inc("tpuml_stage_cache_hits_total")
                    return entry.value, ("wait" if waited else "hit")
                ev = self._inflight.get(key)
                if ev is None:
                    ev = threading.Event()
                    self._inflight[key] = ev
                    break
            waited = True
            ev.wait()

        t0 = time.perf_counter()
        try:
            value = make()
        except BaseException:
            with self._lock:
                self._inflight.pop(key, None)
            ev.set()
            raise
        wall_s = time.perf_counter() - t0
        nbytes = _tree_nbytes(value)
        budget = budget_bytes()
        if strict_enabled() and nbytes > budget:
            # refuse the oversize entry and release the waiters: they retry
            # and hit the same ceiling deterministically
            with self._lock:
                self._stats["unevictable_overflows"] += 1
                self._inflight.pop(key, None)
            ev.set()
            del value
            counter_inc("tpuml_stage_cache_overflow_total")
            record_event("stage.overflow", key=repr(key), nbytes=nbytes,
                         budget_bytes=budget, reason="strict")
            raise StageBudgetExceeded(
                f"staged entry {key!r} is {nbytes / 1e6:.1f} MB but the "
                f"stage budget is {budget / 1e6:.1f} MB (CS230_STAGE_STRICT=1); "
                "stream the dataset instead (CS230_STREAM, data/streaming.py) "
                "or raise CS230_STAGE_CACHE_MB")
        with self._lock:
            self._entries[key] = _Entry(value, nbytes)
            self._entries.move_to_end(key)
            self._bytes += nbytes
            self._stats["misses"] += 1
            self._stats["uploads"] += 1
            self._stats["tunnel_bytes"] += nbytes
            self._uploads_by_key[key] += 1
            if pin:
                self._pin_locked(key)
            evicted, overflow = self._evict_over_budget_locked(exclude=key)
            total_bytes, n_entries = self._bytes, len(self._entries)
            # entry inserted: waiters must see it BEFORE the event fires,
            # or they would loop back into a duplicate upload
            self._inflight.pop(key, None)
        ev.set()
        counter_inc("tpuml_stage_cache_misses_total")
        counter_inc("tpuml_stage_cache_uploads_total")
        counter_inc("tpuml_stage_cache_tunnel_bytes_total", float(nbytes))
        record_event("stage.upload", key=repr(key), nbytes=nbytes, wall_s=round(wall_s, 6),
                     cache_bytes=total_bytes, cache_entries=n_entries)
        for ekey, enbytes in evicted:
            counter_inc("tpuml_stage_cache_evictions_total")
            record_event("stage.evict", key=repr(ekey), nbytes=enbytes)
        if overflow:
            # every survivor is pinned: the cache is committed beyond its
            # budget (live tensors are never dropped), and says so
            counter_inc("tpuml_stage_cache_overflow_total")
            record_event("stage.overflow", key=repr(key), nbytes=nbytes,
                         overflow_bytes=overflow, budget_bytes=budget,
                         cache_bytes=total_bytes, cache_entries=n_entries, reason="pinned")
        return value, "miss"

    def _evict_over_budget_locked(self, exclude: Any = None) -> Tuple[List[Tuple[Any, int]], int]:
        """LRU eviction down to the budget, skipping pinned entries and the
        just-inserted key (a single over-budget dataset stages and serves
        its run, then ages out). Returns the evicted (key, nbytes) and the
        bytes still over budget (non-zero only when every survivor is
        pinned)."""
        budget = budget_bytes()
        evicted: List[Tuple[Any, int]] = []
        if self._bytes <= budget:
            return evicted, 0
        for key in list(self._entries):
            if self._bytes <= budget:
                break
            entry = self._entries[key]
            if key == exclude or entry.refs > 0:
                continue
            del self._entries[key]
            self._bytes -= entry.nbytes
            self._stats["evictions"] += 1
            evicted.append((key, entry.nbytes))
        overflow = max(self._bytes - budget, 0)
        if overflow:
            self._stats["unevictable_overflows"] += 1
        if evicted:
            logger.debug("Staged-dataset cache evicted %d entries (%.1f MB) to fit the "
                         "%.0f MB budget", len(evicted),
                         sum(nb for _, nb in evicted) / 1e6, budget / 1e6)
        return evicted, overflow

    # ---------------- introspection / tests ----------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = dict(self._stats)
            out["entries"] = len(self._entries)
            out["bytes"] = self._bytes
            out["pinned"] = sum(1 for e in self._entries.values() if e.refs > 0)
            return out

    def uploads_by_key(self) -> Dict[Any, int]:
        """Per-key upload counts since process start (or ``clear()``)."""
        with self._lock:
            return dict(self._uploads_by_key)

    def contains(self, key: Any) -> bool:
        with self._lock:
            return key in self._entries

    def keys(self) -> List[Any]:
        with self._lock:
            return list(self._entries)

    def clear(self) -> None:
        """Drop every entry and reset the counters (tests)."""
        with self._lock:
            self._entries.clear()
            self._uploads_by_key.clear()
            self._bytes = 0
            for k in self._stats:
                self._stats[k] = 0


#: the process-global cache every run shares
STAGE_CACHE = StagedDatasetCache()
