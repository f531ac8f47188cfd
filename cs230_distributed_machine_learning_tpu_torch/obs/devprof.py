"""Device-time attribution and on-demand deep profiling.

Port of the JAX package's ``obs/devprof.py``, its capture moved from
``jax.profiler`` to ``torch.profiler``. Two instruments:

- **Per-phase device-seconds**: every executed batch's measured phase
  totals (the trial engine's ``compile`` / ``stage`` / ``dispatch`` /
  ``fetch`` timers) accumulate into
  ``tpuml_executor_device_seconds_total{phase=}``, a *counter*, so the
  embedded time-series ring (obs/timeseries.py) samples it for free. The
  executor feeds it for local batches (:func:`record_batch_device_seconds`)
  and the coordinator's ``push_metrics`` ingest feeds it for remote
  agents' batches (the same ``batch_primary`` + ``obs_pid`` dedup as the
  phase histograms). The streamer (data/streaming.py) feeds ``stream``.
- **Programmatic ``torch.profiler`` capture**: ``POST /profile/start`` /
  ``POST /profile/stop`` (runtime/server.py) bracket a live workload with
  a ``torch.profiler.profile`` over the CPU and, where a card is present,
  CUDA activities; ``stop`` exports a Chrome trace (``trace.json``, for
  ``chrome://tracing`` or ui.perfetto.dev) under
  ``<journal_dir>/profile/<tag>/``. One capture at a time; start and stop
  land in the flight recorder (``profile.start`` / ``profile.stop``).

A ``torch.profiler`` session must be started and stopped on one thread,
and the two HTTP requests arrive on two, so the capture lives on a thread
of its own that opens the session, waits for ``stop`` and exports. The
device activity (CUPTI) is the whole process's: kernels that any thread
launches land in the trace. The CPU-side operator events are the capture
thread's own, so they hold little. After earlier torch.profiler sessions
in the process, a new session drops its first device records (the more,
the more sessions came before), so the capture thread launches
``ABSORB_KERNELS`` tiny kernels of its own before ``start`` returns.

Everything is valve-gated by ``CS230_OBS`` like the rest of ``obs/``:
disabled, the recorder helpers return after one env read and profile
capture refuses to start.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Dict, Optional

from .metrics import REGISTRY
from .recorder import record_event
from .tracing import _enabled, journal_dir

#: the attribution phases, in pipeline order. ``dispatch`` is the device
#: execution window minus the blocking fetches it contains, so the four
#: batch phases sum to (compile + stage + run) wall, not double-counting
#: fetch. ``stream`` is the out-of-core overlap phase: the share of a
#: streaming pass's host->device transfer wall HIDDEN behind compute by
#: the double-buffered uploader (data/streaming.py); the blocking
#: remainder rides the engine's ordinary ``stage`` accumulator, so
#: stage + stream together are the full streamed-transfer wall.
PHASES = ("stage", "compile", "dispatch", "fetch", "stream")

DEVICE_SECONDS = "tpuml_executor_device_seconds_total"

#: the Chrome trace's file name inside a capture's directory
TRACE_FILE = "trace.json"

#: tiny kernels the capture thread launches right after its session starts,
#: so that the records a session drops at its start are these and not the
#: caller's (on an NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py's obs_rest
#: capture held 8 of its 61 kernels without them)
ABSORB_KERNELS = 1024


def device_seconds(phase: str, seconds: float) -> None:
    """Accumulate ``seconds`` of device/pipeline time into ``phase``.

    No-op when ``CS230_OBS=0`` or the duration is non-positive (phases a
    batch never entered add nothing rather than minting zero-valued
    cells)."""
    if not _enabled():
        return
    s = float(seconds)
    if s <= 0.0:
        return
    REGISTRY.counter(DEVICE_SECONDS).inc(s, phase=phase)


def record_batch_device_seconds(
    compile_s: float, stage_s: float, run_s: float, fetch_s: float
) -> None:
    """Attribute one executed batch's phase totals (TrialRunResult's
    timers). ``dispatch`` = the device window minus the blocking fetches
    inside it, clamped at zero: the same decomposition the synthesized
    trace phases use (executor._record_batch_phases)."""
    if not _enabled():
        return
    device_seconds("compile", compile_s)
    device_seconds("stage", stage_s)
    device_seconds("dispatch", max(float(run_s) - float(fetch_s), 0.0))
    device_seconds("fetch", fetch_s)


def phase_totals() -> Dict[str, float]:
    """Current per-phase accumulations (tests / the cash-in report)."""
    c = REGISTRY.counter(DEVICE_SECONDS)
    return {p: c.value(phase=p) for p in PHASES}


def _foreign_profiler_running() -> bool:
    """True while any ``torch.profiler`` / autograd profiler session is
    open in this process (one session at a time: a second start would
    take the first one's session over)."""
    import torch.autograd.profiler as ap

    return bool(getattr(ap, "_is_profiler_enabled", False))


class _Capture(threading.Thread):
    """The thread that owns one ``torch.profiler`` session: opens it,
    reports the outcome of the open, waits for the stop request, closes
    the session and exports the Chrome trace."""

    def __init__(self, trace_dir: str):
        super().__init__(daemon=True, name="tpuml-profile")
        self.trace_dir = trace_dir
        self.opened: "queue.Queue[Optional[BaseException]]" = queue.Queue(1)
        self.closed: "queue.Queue[Optional[BaseException]]" = queue.Queue(1)
        self.stop_requested = threading.Event()

    def run(self) -> None:
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()
        except BaseException as e:  # noqa: BLE001 — reported to start()
            self.opened.put(e)
            return
        try:
            if torch.cuda.is_available():
                z = torch.zeros(1, device="cuda")
                for _ in range(ABSORB_KERNELS):
                    z.add_(1.0)
                torch.cuda.synchronize()
        except BaseException as e:  # noqa: BLE001 — reported to start()
            prof.stop()
            self.opened.put(e)
            return
        self.opened.put(None)
        self.stop_requested.wait()
        try:
            prof.stop()
            prof.export_chrome_trace(os.path.join(self.trace_dir, TRACE_FILE))
        except BaseException as e:  # noqa: BLE001 — reported to stop()
            self.closed.put(e)
            return
        self.closed.put(None)


class DeviceProfiler:
    """One-at-a-time programmatic ``torch.profiler`` capture.

    ``start()`` opens a capture into ``<journal_dir>/profile/<tag>`` and
    ``stop()`` closes it and exports the trace; both record
    flight-recorder events and ``stop`` feeds
    ``tpuml_profile_captures_total``. A second ``start()`` while a capture
    is open is refused as ``busy``, and a ``torch.profiler`` session opened
    elsewhere in the process as ``backend``: callers get a structured
    error instead of a torch exception."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._active: Optional[Dict[str, Any]] = None
        self._capture: Optional[_Capture] = None

    def status(self) -> Dict[str, Any]:
        with self._lock:
            if self._active is None:
                return {"active": False}
            return {"active": True, **self._active}

    def start(self, tag: Optional[str] = None) -> Dict[str, Any]:
        """Begin a capture. Returns ``{status: "started", trace_dir: ...}``
        or a structured error dict (``status: "error"``) whose ``reason``
        tells the transport layer what happened: ``disabled`` (valve off
        -> 503), ``busy`` (capture already open -> 409), or ``backend``
        (the profiler/filesystem refused, or another torch.profiler session
        is open in the process -> 500)."""
        if not _enabled():
            return {
                "status": "error",
                "reason": "disabled",
                "message": "observability disabled (CS230_OBS=0)",
            }
        tag = _sanitize_tag(tag) or time.strftime("%Y%m%d-%H%M%S")
        trace_dir = os.path.join(journal_dir(), "profile", tag)
        with self._lock:
            if self._active is not None:
                return {
                    "status": "error",
                    "reason": "busy",
                    "message": "capture already active",
                    **self._active,
                }
            try:
                if _foreign_profiler_running():
                    raise RuntimeError(
                        "a torch.profiler session is already running in this process")
                os.makedirs(trace_dir, exist_ok=True)
                capture = _Capture(trace_dir)
                capture.start()
                err = capture.opened.get()
                if err is not None:
                    raise err
            except Exception as e:  # noqa: BLE001 — surface, don't crash the server
                return {"status": "error", "reason": "backend",
                        "message": f"{type(e).__name__}: {e}"}
            self._capture = capture
            self._active = {
                "tag": tag,
                "trace_dir": trace_dir,
                "started_ts": time.time(),
            }
            info = dict(self._active)
        record_event("profile.start", tag=tag, trace_dir=trace_dir)
        return {"status": "started", **info}

    def stop(self) -> Dict[str, Any]:
        """Finish the active capture. Returns ``{status: "stopped",
        trace_dir, duration_s, n_files}`` or an error when none is
        active. A failed stop or export clears the capture: its session
        ended with its thread, so nothing is left to retry."""
        with self._lock:
            if self._active is None:
                return {"status": "error", "reason": "idle",
                        "message": "no active capture"}
            info, capture = self._active, self._capture
            capture.stop_requested.set()
            err = capture.closed.get()
            capture.join()
            self._active = self._capture = None
            if err is not None:
                record_event("profile.stop", tag=info["tag"], error=str(err))
                return {"status": "error", "reason": "backend",
                        "message": f"{type(err).__name__}: {err}", **info}
        duration = time.time() - info["started_ts"]
        n_files = sum(len(fs) for _, _, fs in os.walk(info["trace_dir"]))
        REGISTRY.counter(
            "tpuml_profile_captures_total",
        ).inc()
        record_event(
            "profile.stop", tag=info["tag"], trace_dir=info["trace_dir"],
            duration_s=round(duration, 3), n_files=n_files,
        )
        return {
            "status": "stopped",
            "tag": info["tag"],
            "trace_dir": info["trace_dir"],
            "duration_s": duration,
            "n_files": n_files,
        }


def _sanitize_tag(tag: Optional[str]) -> Optional[str]:
    """Capture tags come off the wire and become a path component: keep
    [-._a-zA-Z0-9] only, so a request cannot traverse out of the journal
    dir."""
    if not tag:
        return None
    clean = "".join(c for c in str(tag) if c.isalnum() or c in "-._")
    return clean.strip(".") or None


#: the process-global profiler the /profile routes drive
PROFILER = DeviceProfiler()
