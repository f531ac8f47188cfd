"""Out-of-core row-block streaming: datasets bigger than the stage budget.

Port of the JAX package's ``data/streaming.py``. The trial engine
(parallel/trial_map.py::_run_streamed) takes a bucket whose staged form
crowds the stage budget (``data/stage_cache.py``) off the single-shot
upload: its kernel's ``stream_scores`` accumulates gradients or
histograms over row blocks instead, and no tensor of ``n`` rows of the
design matrix is ever device-resident.

- **row-block plans** (``plan_blocks``, framework-free, copied): uniform
  row blocks, ``CS230_STREAM_BLOCK_ROWS`` or ~1/8 of the stage budget
  each; the last block is zero-padded (pad rows carry zero sample
  weights and add nothing).
- **blocks are ordinary staged entries**: block ``i`` lives in the stage
  cache under ``(dataset_fingerprint, host_signature(), "block", *form,
  i)``, so concurrent tenants share uploads (single-flight), repeat passes
  hit while the budget allows, and LRU eviction reclaims consumed blocks.
- **upload** (``RowBlockStreamer``, rewritten for CUDA): by default the
  consumer stages each block itself. Opt-in double buffering
  (``CS230_STREAM_DOUBLE_BUFFER=1``): a one-worker prefetch thread stages
  block ``i+1`` while the caller computes on block ``i``. It is off by
  default because on an H100 host it made both streamed jobs slower
  (PERF.md §6): the consumers are host-bound, and the worker's copies
  took twice as long beside them. The uploader copies the host block
  into a pinned buffer and from there to the device with
  ``non_blocking=True`` on a side ``torch.cuda.Stream``, records an event
  and waits on that event alone; the consumer's stream waits on the event
  too, and the block is recorded on the consumer's stream so the caching
  allocator keeps its memory until the consumer's work is done.
  In-flight and prefetched blocks hold an explicit cache ref.
- **per-host block sets** (``host_block_set``) and **disk-backed blocks**
  (``CsvBlockSource`` over ``data/download.py::iter_csv_chunks`` and the
  two-pass scaler of ``data/preprocess.py``), copied.

Valves (the JAX package's names; the consuming kernels join the resolved
mode into ``trace_salt``): ``CS230_STREAM`` = ``auto`` (default: stream
past the stage budget) | ``0``/``off`` | ``1``/``force``;
``CS230_STREAM_BLOCK_ROWS``; ``CS230_STREAM_DOUBLE_BUFFER=1`` (the
JAX package's default; off here).

Observability: ``tpuml_stream_*`` counters and one ``stage.stream``
flight-recorder event per pass. The device profile's ``stream`` phase
waits for the port's ``obs/devprof.py`` (ROADMAP A4).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from ..obs import counter_inc, record_event
from .stage_cache import STAGE_CACHE, _tree_nbytes, budget_bytes

#: floor on the auto block height — below this the per-block dispatch
#: overhead dominates any transfer overlap
_MIN_BLOCK_ROWS = 256

#: auto-sized blocks target this fraction of the stage-cache budget, so a
#: (double-buffered) pair plus the padded fold tensors and a few
#: consumed-but-unevicted blocks stay inside it
_BLOCK_BUDGET_FRACTION = 8


def stream_mode() -> str:
    """Resolve ``CS230_STREAM``: ``off`` | ``auto`` | ``force``. Read per
    call; consuming kernels fold the RESOLVED mode into ``trace_salt``."""
    raw = os.environ.get("CS230_STREAM", "auto").lower()
    if raw in ("0", "off", "false"):
        return "off"
    if raw in ("1", "force"):
        return "force"
    return "auto"


def stream_double_buffer() -> bool:
    """CS230_STREAM_DOUBLE_BUFFER=1 enables the prefetch worker."""
    return os.environ.get("CS230_STREAM_DOUBLE_BUFFER", "0") == "1"


def should_stream(nbytes: int) -> bool:
    """Stream a dataset whose single-shot staged footprint is ``nbytes``?
    ``force``/``off`` override; ``auto`` streams when the single-shot
    upload would overflow the stage-cache budget (by default 40 % of the
    card's memory). The JAX package streams past half its budget; here a
    dataset between half the budget and all of it stages whole, because
    the streamed path re-uploads every block on every pass."""
    mode = stream_mode()
    if mode == "off":
        return False
    if mode == "force":
        return True
    return float(nbytes) > budget_bytes()


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """Uniform row-block tiling of an ``n``-row dataset: ``n_blocks``
    blocks of ``rows`` rows each; the last block is zero-padded up to
    ``rows`` (consumers see zero sample weights on pad rows)."""

    n: int
    rows: int
    n_blocks: int

    @property
    def n_pad(self) -> int:
        return self.rows * self.n_blocks

    def start(self, i: int) -> int:
        return i * self.rows

    def size(self, i: int) -> int:
        """Real (unpadded) rows of block ``i``."""
        return min(self.n, (i + 1) * self.rows) - i * self.rows

    def block_ids(self) -> range:
        return range(self.n_blocks)


def plan_blocks(n: int, row_bytes: int, rows: Optional[int] = None) -> BlockPlan:
    """Tile ``n`` rows of ``row_bytes`` bytes each into uniform blocks.
    ``CS230_STREAM_BLOCK_ROWS`` (or the ``rows`` argument) pins the block
    height; the default targets ``budget_bytes() / 8`` per block."""
    if rows is None:
        env = os.environ.get("CS230_STREAM_BLOCK_ROWS")
        if env:
            try:
                rows = max(int(float(env)), 1)
            except ValueError:
                rows = None
    if rows is None:
        target = max(budget_bytes() // _BLOCK_BUDGET_FRACTION, 1)
        rows = max(_MIN_BLOCK_ROWS, int(target // max(int(row_bytes), 1)))
    rows = max(1, min(int(rows), max(int(n), 1)))
    n_blocks = max(1, -(-int(n) // rows))
    return BlockPlan(n=int(n), rows=rows, n_blocks=n_blocks)


def host_block_set(n_blocks: int, n_shards: int, shard_idx: int) -> range:
    """Disjoint contiguous block range for one host of a row-sharded
    mesh: every block belongs to exactly one shard; shards differ in size
    by at most one block."""
    if not 0 <= shard_idx < n_shards:
        raise ValueError(f"shard_idx {shard_idx} outside [0, {n_shards})")
    base, extra = divmod(int(n_blocks), int(n_shards))
    start = shard_idx * base + min(shard_idx, extra)
    stop = start + base + (1 if shard_idx < extra else 0)
    return range(start, stop)


def pad_rows(blk: np.ndarray, rows: int) -> np.ndarray:
    """Zero-pad a partial tail block up to the uniform block height."""
    short = rows - blk.shape[0]
    if short <= 0:
        return blk
    pad = np.zeros((short,) + blk.shape[1:], blk.dtype)
    return np.concatenate([blk, pad], axis=0)


def array_block_source(arr, plan: BlockPlan) -> Callable[[int], np.ndarray]:
    """Host block fetcher over an in-memory array: slice + zero-pad."""

    def fetch(i: int) -> np.ndarray:
        s = plan.start(i)
        blk = np.asarray(arr[s : s + plan.rows])
        return pad_rows(blk, plan.rows)

    return fetch


class _Uploader:
    """Host block -> device tensor. On the card: through a pinned host
    buffer, copied with ``non_blocking=True`` on a side stream; the call
    waits on its own copy's event (never a device-wide sync) before it
    returns, so the wall it takes is the upload and the buffer is free for
    the next block. Returns (tensor, event) on the card, the tensor on the
    CPU."""

    def __init__(self, device):
        import torch

        self.device = device
        self._lock = threading.Lock()
        self._buf = None
        self._stream = torch.cuda.Stream(device=device) if device.type == "cuda" else None

    def __call__(self, host: np.ndarray):
        import torch

        src = torch.from_numpy(np.ascontiguousarray(host))
        if self._stream is None:
            return src.clone()
        with self._lock:
            if self._buf is None or self._buf.shape != src.shape or self._buf.dtype != src.dtype:
                self._buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            self._buf.copy_(src)
            # a thread's current stream is its own: the worker sets it here
            with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
                val = self._buf.to(self.device, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self._stream)
            ev.synchronize()
        return val, ev


class RowBlockStreamer:
    """Double-buffered iterator over staged row blocks.

    ``iter_blocks()`` yields ``(block_id, row_start, device_tensor)`` in
    ascending block order; call it once per pass over the data (a solver
    makes one pass per iteration). While a pass runs, the in-flight block
    and the prefetched next block each hold an explicit stage-cache ref,
    released as the consumer advances: LRU pressure from other tenants
    evicts only blocks the pass is done with, and a repeat pass re-stages
    (or re-hits) them through the ordinary single-flight path.

    ``fetch_host(i)`` produces the host block (already padded to
    ``plan.rows``); the upload to ``device`` runs on the prefetch worker
    when double-buffering is on.
    """

    def __init__(self, base_key: tuple, fetch_host: Callable[[int], Any], plan: BlockPlan,
                 *, device, block_ids: Optional[Iterable[int]] = None,
                 double_buffer: Optional[bool] = None, cache=None,
                 row_shape: Optional[Tuple[int, ...]] = None):
        self._base_key = tuple(base_key)
        self._fetch_host = fetch_host
        self.plan = plan
        self.device = device
        #: per-row feature shape of a block (drivers derive their state's
        #: geometry from it)
        self.row_shape = tuple(row_shape) if row_shape is not None else None
        self._ids = list(block_ids) if block_ids is not None else list(plan.block_ids())
        self._db = stream_double_buffer() if double_buffer is None else bool(double_buffer)
        self._cache = cache if cache is not None else STAGE_CACHE
        self._upload = _Uploader(device)
        self._stats_lock = threading.Lock()
        self.stats = {
            "passes": 0,
            "blocks": 0,       # blocks yielded (hits + uploads)
            "uploads": 0,      # blocks that paid an upload
            "bytes": 0,        # bytes uploaded
            "upload_s": 0.0,   # upload wall on the worker (misses only)
            "wait_s": 0.0,     # consumer blocked waiting for a block
        }

    def block_key(self, i: int) -> tuple:
        return self._base_key + (int(i),)

    def block_ids(self) -> List[int]:
        return list(self._ids)

    # ---------------- internals ----------------

    def _acquire(self, i: int):
        """Stage (or hit) block ``i`` with an explicit cache ref held. Runs
        on the prefetch worker when double-buffering is on. Returns (key,
        tensor, outcome, wall, bytes, the copy's event or None)."""
        key = self.block_key(i)
        made = {}

        def make():
            out = self._upload(self._fetch_host(int(i)))
            val, made["event"] = out if isinstance(out, tuple) else (out, None)
            made["nbytes"] = _tree_nbytes(val)
            return val

        t0 = time.perf_counter()
        val, outcome = self._cache.acquire(key, make)
        wall = time.perf_counter() - t0
        return key, val, outcome, wall, made.get("nbytes", 0), made.get("event")

    def _hand_over(self, val, event):
        """Make the consumer's stream wait on the block's copy, and record
        the block on that stream: once the cache drops it, the caching
        allocator must not reuse its memory before the consumer's queued
        work has read it."""
        if self.device.type != "cuda":
            return
        import torch

        consumer = torch.cuda.current_stream(self.device)
        if event is not None:
            consumer.wait_event(event)
        val.record_stream(consumer)

    def iter_blocks(self) -> Iterator[Tuple[int, int, Any]]:
        """One pass over the block set, in ascending order. Re-invoke for
        each additional pass (stats accumulate across passes)."""
        ids = list(self._ids)
        ex = (ThreadPoolExecutor(max_workers=1, thread_name_prefix="tpuml-stream")
              if self._db and len(ids) > 1 else None)
        pending: "collections.deque" = collections.deque()
        pos = 0
        blocks = uploads = nbytes = 0
        upload_s = wait_s = 0.0

        def submit():
            nonlocal pos
            if pos < len(ids):
                i = ids[pos]
                pos += 1
                fut = ex.submit(self._acquire, i) if ex is not None else None
                pending.append((i, fut))

        try:
            submit()
            while pending:
                # keep exactly one extra block in flight: the worker uploads
                # block i+1 while the caller computes on block i
                submit()
                i, fut = pending.popleft()
                t0 = time.perf_counter()
                if fut is not None:
                    key, val, outcome, up_wall, up_bytes, event = fut.result()
                else:
                    key, val, outcome, up_wall, up_bytes, event = self._acquire(i)
                wait_s += time.perf_counter() - t0
                blocks += 1
                if outcome != "hit":
                    uploads += 1
                    nbytes += up_bytes
                    upload_s += up_wall
                counter_inc("tpuml_stream_blocks_total")
                self._hand_over(val, event)
                try:
                    yield i, self.plan.start(i), val
                finally:
                    # the consumer advanced: this block is evictable again
                    self._cache.release(key)
        finally:
            # abandoned pass / worker error: drop refs the prefetcher took
            while pending:
                _, fut = pending.popleft()
                if fut is None:
                    continue
                try:
                    key = fut.result()[0]
                except BaseException:  # noqa: BLE001 — maker failed: no ref
                    continue
                self._cache.release(key)
            if ex is not None:
                ex.shutdown(wait=True)
            self._finish_pass(blocks, uploads, nbytes, upload_s, wait_s)

    def _finish_pass(self, blocks, uploads, nbytes, upload_s, wait_s):
        if blocks == 0:
            return
        with self._stats_lock:
            self.stats["passes"] += 1
            self.stats["blocks"] += blocks
            self.stats["uploads"] += uploads
            self.stats["bytes"] += nbytes
            self.stats["upload_s"] += upload_s
            self.stats["wait_s"] += wait_s
        hidden_s = max(upload_s - wait_s, 0.0)
        counter_inc("tpuml_stream_passes_total")
        if nbytes:
            counter_inc("tpuml_stream_bytes_total", float(nbytes))
        if upload_s > 0.0:
            counter_inc("tpuml_stream_upload_seconds_total", upload_s)
        if wait_s > 0.0:
            counter_inc("tpuml_stream_wait_seconds_total", wait_s)
        record_event(
            "stage.stream", blocks=blocks, uploads=uploads, nbytes=nbytes,
            upload_s=round(upload_s, 6), wait_s=round(wait_s, 6),
            hidden_s=round(hidden_s, 6),
            hidden_frac=round(hidden_s / upload_s, 4) if upload_s > 0.0 else None,
            double_buffer=self._db,
        )

    # ---------------- derived stats ----------------

    def hidden_fraction(self) -> Optional[float]:
        """Share of the cumulative transfer wall hidden behind compute:
        ``1 - wait/upload`` (None until an upload happened)."""
        with self._stats_lock:
            up, wait = self.stats["upload_s"], self.stats["wait_s"]
        if up <= 0.0:
            return None
        return max(0.0, 1.0 - wait / up)


class CsvBlockSource:
    """Sequential, rewindable host block source over chunked CSV ingest.

    ``open_blocks()`` must return a fresh iterator of row arrays (any
    chunk heights — e.g. ``data/preprocess.py::iter_design_blocks``); this
    class re-chunks them to the plan's uniform block height. ``fetch(i)``
    serves ascending block indices within a pass; an index rewind (a new
    pass) restarts the underlying reader, so the full matrix never
    materializes on the host — the resident set is one reader chunk plus
    one assembled block.
    """

    def __init__(self, open_blocks: Callable[[], Iterable[np.ndarray]], plan: BlockPlan):
        self._open = open_blocks
        self.plan = plan
        self._lock = threading.Lock()
        self._reader: Optional[Iterator[np.ndarray]] = None
        self._next_block = 0
        self._buf: List[np.ndarray] = []
        self._buf_rows = 0

    def _restart(self):
        self._reader = iter(self._open())
        self._next_block = 0
        self._buf = []
        self._buf_rows = 0

    def fetch(self, i: int) -> np.ndarray:
        rows = self.plan.rows
        with self._lock:
            if self._reader is None or i < self._next_block:
                self._restart()
            if i > self._next_block:
                # a skipped-ahead fetch (per-host block sets): discard
                # intervening rows without assembling them into blocks
                for _ in range(self._next_block, i):
                    self._fill(rows)
                    self._drop(rows)
                    self._next_block += 1
            self._fill(rows)
            blk = self._take(rows)
            self._next_block += 1
        return pad_rows(blk, rows)

    def _fill(self, rows: int):
        while self._buf_rows < rows and self._reader is not None:
            try:
                chunk = np.asarray(next(self._reader))
            except StopIteration:
                self._reader = None
                break
            if chunk.shape[0]:
                self._buf.append(chunk)
                self._buf_rows += chunk.shape[0]

    def _take(self, rows: int) -> np.ndarray:
        got: List[np.ndarray] = []
        need = rows
        while need > 0 and self._buf:
            head = self._buf[0]
            if head.shape[0] <= need:
                got.append(head)
                need -= head.shape[0]
                self._buf.pop(0)
            else:
                got.append(head[:need])
                self._buf[0] = head[need:]
                need = 0
        self._buf_rows -= sum(g.shape[0] for g in got)
        if not got:
            return np.zeros((0,), np.float32)
        return np.concatenate(got, axis=0) if len(got) > 1 else got[0]

    def _drop(self, rows: int):
        self._take(rows)
