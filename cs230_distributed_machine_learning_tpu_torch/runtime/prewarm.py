"""Background prewarm: warm the hot job shapes before the first trial.

A copy of the JAX package's ``runtime/prewarm.py``. In the port, what a
hint warms is the kernel libraries' build and load (utils/aot_cache.py:
eager PyTorch has no executables to deserialize) and the hinted dataset's
staging (``LocalExecutor.prewarm_hint``); the JAX text below speaks of
its AOT executables.

The r5 cold-start breakdown charges 2.2 s of every fresh worker's first
trial to AOT executable loading and 3.4 s to the staging upload — pure
data-plane latency paid INLINE, while the worker sat idle between
register and first placement. This module moves that work into the idle
window: when a worker registers, the coordinator ships prewarm *hints*
(the runtime predictor's hot model families, each bound to the dataset /
parameter shape of a recent job — ``Coordinator.prewarm_hints``), and the
agent runs a :class:`PrewarmWorker` thread that warms one hint at a time
via ``LocalExecutor.prewarm_hint``:

- ``construct`` mode (default): build every bucket executable (AOT blob
  deserialize or trace) and upload the staged tensors — the two measured
  cold costs — without dispatching anything
  (``trial_map.run_trials(warm_only=True)``).
- ``execute`` mode (``CS230_PREWARM=execute``): additionally dispatch the
  warmed bucket once with the hinted parameters and discard the result,
  so the first real trial also skips the first-dispatch XLA compile.

The worker **yields to real work**: before each hint it waits while the
executor has live batches in flight, and it never warms the same
(family, dataset, geometry) twice. ``CS230_PREWARM=0`` disables the
whole path (parity valve: registration and the first trial behave
exactly as before this layer existed).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, List, Optional

from ..obs import counter_inc, record_event
from ..utils import aot_cache
from ..utils.logging import get_logger

logger = get_logger("tpuml.prewarm")


def prewarm_mode() -> str:
    """``off`` (CS230_PREWARM=0), ``construct`` (default), or
    ``execute``."""
    raw = os.environ.get("CS230_PREWARM", "1").strip().lower()
    if raw in ("0", "off", "false"):
        return "off"
    if raw == "execute":
        return "execute"
    return "construct"


def enabled() -> bool:
    return prewarm_mode() != "off"


def max_hints() -> int:
    """Hints warmed per registration (``CS230_PREWARM_MAX_HINTS``,
    default 3) — bounds background device time on a busy fleet."""
    try:
        return max(int(os.environ.get("CS230_PREWARM_MAX_HINTS", 3)), 0)
    except ValueError:
        return 3


class PrewarmWorker:
    """Bounded background warmer over a list of coordinator hints.

    ``is_busy`` is polled before each hint; while it returns True the
    worker sleeps (``yield_poll_s``) instead of competing with live
    batches for the device. Defaults to the executor's in-flight batch
    flag (``LocalExecutor.busy``)."""

    def __init__(
        self,
        executor,
        hints: List[Dict[str, Any]],
        *,
        is_busy: Optional[Callable[[], bool]] = None,
        mode: Optional[str] = None,
        yield_poll_s: float = 0.05,
        limit: Optional[int] = None,
    ):
        self.executor = executor
        self.hints = list(hints)[: (limit if limit is not None else max_hints())]
        self.mode = mode or prewarm_mode()
        self.yield_poll_s = yield_poll_s
        self._is_busy = is_busy or (
            lambda: bool(getattr(executor, "busy", False))
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: (family, dataset, geometry) keys already warmed — a family is
        #: never compiled twice by this worker (pinned in tests)
        self._warmed: set = set()
        #: per-hint warm summaries, in completion order
        self.results: List[Dict[str, Any]] = []
        self.done = threading.Event()

    @staticmethod
    def _hint_key(hint: Dict[str, Any]) -> tuple:
        return (
            hint.get("model_type"),
            hint.get("dataset_id"),
            int(hint.get("n_trials") or 1),
            repr(sorted((hint.get("parameters") or {}).items())),
            repr(sorted(
                (k, str(v)) for k, v in (hint.get("train_params") or {}).items()
            )),
        )

    def start(self) -> None:
        if self._thread is not None or self.mode == "off" or not self.hints:
            self.done.set()
            return
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def join(self, timeout: Optional[float] = None) -> bool:
        return self.done.wait(timeout)

    def _run(self) -> None:
        try:
            inventory = aot_cache.generation_inventory()
            if inventory["n_blobs"]:
                logger.info(
                    "Prewarm: %d AOT blobs (%.1f MB) on disk for this "
                    "generation",
                    inventory["n_blobs"], inventory["bytes"] / 1e6,
                )
            for hint in self.hints:
                if self._stop.is_set():
                    break
                # yield to real placements: a live batch always wins the
                # device; prewarm resumes when the executor idles
                while self._is_busy() and not self._stop.is_set():
                    self._stop.wait(self.yield_poll_s)
                if self._stop.is_set():
                    break
                key = self._hint_key(hint)
                if key in self._warmed:
                    counter_inc(
                        "tpuml_prewarm_skipped_total", reason="duplicate"
                    )
                    continue
                self._warmed.add(key)
                family = str(hint.get("model_type"))
                try:
                    summary = self.executor.prewarm_hint(hint, mode=self.mode)
                except Exception:  # noqa: BLE001 — a bad hint must never
                    # hurt the worker it was meant to help
                    logger.exception("Prewarm failed for family %s", family)
                    counter_inc("tpuml_prewarm_skipped_total", reason="error")
                    continue
                counter_inc("tpuml_prewarm_warmed_total", model=family)
                record_event("prewarm.warm", **summary)
                logger.info(
                    "Prewarmed %s on %s (%s: compile %.2fs, stage %.2fs)",
                    family, hint.get("dataset_id"), summary.get("mode"),
                    summary.get("compile_s") or 0.0,
                    summary.get("stage_s") or 0.0,
                )
                self.results.append(summary)
        finally:
            self.done.set()
