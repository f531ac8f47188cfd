"""Critical-path engine: exact end-to-end wall-clock decomposition of a job.

A copy of the JAX package's ``obs/critpath.py`` (framework-free).

Five observability layers collect — spans (tracing.py), device cost
(devprof.py), the flight recorder (recorder.py), phase-attributed
device-seconds, fleet alerts — but none of them *analyzes*: nothing
answers "this job took 40 s wall — which 40 s?". This module does, by
joining a job's span tree with its flight-recorder timelines and tiling
the measured wall [t0, t1] with labeled segments:

    frontend.proxy → submit → expand → queue.wait → place →
    executor.{compile,stage,dispatch,fetch} → result.ingest → aggregate

The tiling is EXACT by construction: candidate intervals (spans, plus
intervals derived from recorder events — queue wait before the first
placement, the lease-reclaim wait of a hung attempt, the gap between a
batch finishing and its result ingesting) are swept over the window and
the most-specific candidate wins each slice; slices nothing covers are
labeled ``untraced`` rather than silently absorbed, so
``sum(segment durations) == wall`` always holds and the untraced
fraction is an honest data-quality signal.

Retried and speculative attempts charge only their on-critical-path
portion: the engine picks the *critical subtask* (the one whose terminal
result the aggregate waited on last) and, within it, the *winning
attempt* (the attempt stamped on the accepted result) — a speculative
loser's executor spans and a superseded attempt's phases never enter the
candidate set, while the reclaim wait that preceded a re-place does
(it was real wall time the job spent hung).

``compare(a, b)`` diffs two reports segment-by-segment and attributes
the wall-clock delta — the interpretability layer for perf-observatory
A/B runs and before/after benchmark pairs.

Pure functions over plain dicts: the coordinator feeds it
``TRACER.spans_for(tid)`` + ``RECORDER.timeline(...)`` per subtask
(runtime/coordinator.py ``critical_path``); tests feed synthetic spans.
Served at ``GET /critical_path/<job_id>`` (docs/OBSERVABILITY.md
"Critical path & trace export").
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

#: span names that can open a job's wall-clock window, most-upstream
#: first — the earliest of these that exists anchors t0
_ROOT_NAMES = ("frontend.proxy", "http.train", "http.train_status",
               "client.train", "job.submit")
#: span names that can close the window — the latest end wins
_TAIL_NAMES = ("job.aggregate", "job.execute", "job.submit")

#: terminal result statuses (the event the aggregate waited on)
_TERMINAL = {"completed", "failed", "pruned"}

#: synthesized per-phase executor spans (children of executor.batch)
_PHASE_NAMES = ("executor.compile", "executor.stage",
                "executor.dispatch", "executor.fetch")


def _f(v: Any, default: float = 0.0) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return default


class _Candidate:
    __slots__ = ("start", "end", "name", "prio", "detail")

    def __init__(self, start: float, end: float, name: str, prio: int,
                 detail: Optional[Dict[str, Any]] = None):
        self.start = start
        self.end = end
        self.name = name
        self.prio = prio
        self.detail = detail or {}


def _pick_critical_subtask(
    timelines: Dict[str, List[Dict[str, Any]]]
) -> Tuple[Optional[str], Optional[Dict[str, Any]]]:
    """The subtask whose terminal result landed LAST — the one the
    aggregate barrier actually waited on. Returns (subtask_id, its
    terminal result event)."""
    best_stid, best_ev = None, None
    for stid, events in timelines.items():
        for ev in events or []:
            if ev.get("kind") != "result":
                continue
            if (ev.get("data") or {}).get("status") not in _TERMINAL:
                continue
            if best_ev is None or _f(ev.get("ts")) > _f(best_ev.get("ts")):
                best_stid, best_ev = stid, ev
    return best_stid, best_ev


def _span_window(spans: List[Dict[str, Any]]) -> Tuple[float, float]:
    starts = {n: min(_f(s.get("start")) for s in spans if s["name"] == n)
              for n in {s["name"] for s in spans}}
    ends = {n: max(_f(s.get("end")) for s in spans if s["name"] == n)
            for n in {s["name"] for s in spans}}
    t0 = None
    for name in _ROOT_NAMES:
        if name in starts:
            t0 = starts[name] if t0 is None else min(t0, starts[name])
    if t0 is None:
        t0 = min(_f(s.get("start")) for s in spans)
    t1 = None
    for name in _TAIL_NAMES:
        if name in ends:
            t1 = ends[name] if t1 is None else max(t1, ends[name])
    if t1 is None:
        t1 = max(_f(s.get("end")) for s in spans)
    return t0, max(t1, t0)


def critical_path(
    job_id: str,
    *,
    trace_id: Optional[str],
    spans: List[Dict[str, Any]],
    timelines: Optional[Dict[str, List[Dict[str, Any]]]] = None,
    job_wall_s: Optional[float] = None,
) -> Optional[Dict[str, Any]]:
    """Decompose one job's wall clock into labeled critical-path segments.

    ``spans`` is the job trace (TRACER.spans_for), ``timelines`` maps
    subtask_id -> flight-recorder events (RECORDER.timeline);
    ``job_wall_s`` is the store-measured wall (created_at ->
    completion_time) reported alongside for cross-checking. Returns None
    when there are no spans at all (nothing to decompose)."""
    if not spans:
        return None
    timelines = timelines or {}
    t0, t1 = _span_window(spans)
    wall = t1 - t0

    cands: List[_Candidate] = []

    def add(start, end, name, prio, **detail):
        start, end = _f(start), _f(end)
        # clamp to the window; degenerate intervals never tile anything
        start, end = max(start, t0), min(end, t1)
        if end > start:
            cands.append(_Candidate(start, end, name, prio, detail))

    # ---- span-derived candidates (control-plane skeleton) ----
    for s in spans:
        name, st, en = s["name"], s.get("start"), s.get("end")
        attrs = s.get("attrs") or {}
        if name == "frontend.proxy":
            add(st, en, "frontend.proxy", 1, route=attrs.get("route"))
        elif name in ("http.train", "http.train_status"):
            add(st, en, "submit.http", 2)
        elif name == "job.submit":
            add(st, en, "submit", 3)
        elif name == "job.expand":
            add(st, en, "expand", 4)
        elif name == "job.aggregate":
            add(st, en, "aggregate", 4)

    # ---- critical subtask: pick it, then walk its attempts ----
    crit_stid, result_ev = _pick_critical_subtask(timelines)
    crit_events = timelines.get(crit_stid) or [] if crit_stid else []
    win_attempt = int(result_ev.get("attempt") or 0) if result_ev else None
    win_worker = result_ev.get("worker_id") if result_ev else None
    result_ts = _f(result_ev.get("ts")) if result_ev else None
    placements = [e for e in crit_events if e.get("kind") == "placement"]
    reclaims = [e for e in crit_events if e.get("kind") == "lease.reclaim"]
    spec_wins = [e for e in crit_events if e.get("kind") == "speculate.win"]

    exec_start = next(
        (_f(s.get("start")) for s in spans if s["name"] == "job.execute"),
        None,
    )
    if placements:
        first_place = min(_f(e.get("ts")) for e in placements)
        q0 = exec_start if exec_start is not None else t0
        add(q0, first_place, "queue.wait", 2,
            subtask_id=crit_stid)

    # placement decisions themselves (back-dated schedule.place spans)
    for s in spans:
        if s["name"] != "schedule.place":
            continue
        attrs = s.get("attrs") or {}
        if crit_stid and attrs.get("subtask_id") == crit_stid:
            add(s.get("start"), s.get("end"), "place", 5,
                worker=attrs.get("worker"), attempt=attrs.get("attempt"))

    # the reclaim wait of every superseded attempt IS critical-path time:
    # the job sat hung from that attempt's placement until the sweeper
    # reclaimed the lease and re-placed
    for rec in reclaims:
        r_attempt = int(rec.get("attempt") or 0)
        p_ts = max(
            (_f(p.get("ts")) for p in placements
             if int(p.get("attempt") or 0) == r_attempt),
            default=None,
        )
        if p_ts is not None:
            add(p_ts, _f(rec.get("ts")), "reclaim.wait", 4,
                attempt=r_attempt, worker=rec.get("worker_id"),
                overdue_s=(rec.get("data") or {}).get("overdue_s"))

    # ---- winning attempt's executor window (only the winner charges) ----
    win_place_ts = None
    if placements and win_attempt is not None:
        win_place_ts = max(
            (_f(p.get("ts")) for p in placements
             if int(p.get("attempt") or 0) == win_attempt),
            default=None,
        )
    batch_end = None
    if win_worker and result_ts is not None:
        lo = win_place_ts if win_place_ts is not None else t0
        batch_windows: Dict[Any, Tuple[float, float]] = {}
        for s in spans:
            if s["name"] != "executor.batch":
                continue
            if (s.get("attrs") or {}).get("worker") != win_worker:
                continue
            b0, b1 = _f(s.get("start")), _f(s.get("end"))
            # the winner's batch overlaps [placement, result]; a
            # speculative loser or stale attempt ran elsewhere/elsewhen.
            # Only the portion up to the result event is on the critical
            # path — a batch tail past its own result (other subtasks
            # still in the batch) belongs to them, not this job's wall.
            if b1 < lo or b0 > result_ts:
                continue
            b1 = min(b1, result_ts)
            add(b0, b1, "execute", 6, worker=win_worker)
            batch_windows[s.get("span_id")] = (b0, b1)
            batch_end = b1 if batch_end is None else max(batch_end, b1)
        for s in spans:
            win = batch_windows.get(s.get("parent_id"))
            if s["name"] in _PHASE_NAMES and win is not None:
                # synthesized phases carry exact DURATIONS but indicative
                # offsets (laid sequentially from batch start while real
                # phases overlap — executor._record_batch_phases): clamp
                # to the parent batch envelope so an overrunning phase
                # estimate can never eat into post-batch segments
                # (result.ingest, aggregate)
                add(max(_f(s.get("start")), win[0]),
                    min(_f(s.get("end")), win[1]), s["name"], 7)
        if batch_end is not None and result_ts > batch_end:
            add(batch_end, result_ts, "result.ingest", 3,
                subtask_id=crit_stid)

    # ---- sweep: most-specific candidate wins each elementary slice ----
    bounds = sorted({t0, t1, *(c.start for c in cands),
                     *(c.end for c in cands)})
    segments: List[Dict[str, Any]] = []
    for lo, hi in zip(bounds, bounds[1:]):
        if hi <= lo:
            continue
        best: Optional[_Candidate] = None
        for c in cands:
            if c.start <= lo and c.end >= hi:
                if best is None or c.prio > best.prio:
                    best = c
        name = best.name if best is not None else "untraced"
        detail = best.detail if best is not None else {}
        if segments and segments[-1]["name"] == name:
            segments[-1]["end"] = hi
        else:
            segments.append({"name": name, "start": lo, "end": hi,
                             "detail": detail})

    totals: Dict[str, float] = {}
    for seg in segments:
        seg["duration_s"] = seg["end"] - seg["start"]
        seg["fraction"] = seg["duration_s"] / wall if wall > 0 else 0.0
        totals[seg["name"]] = totals.get(seg["name"], 0.0) + seg["duration_s"]
    untraced_s = totals.get("untraced", 0.0)

    return {
        "job_id": job_id,
        "trace_id": trace_id,
        "t0": t0,
        "t1": t1,
        "wall_s": wall,
        "job_wall_s": job_wall_s,
        "critical_subtask": crit_stid,
        "winning_attempt": win_attempt,
        "winning_worker": win_worker,
        "n_attempts": (max((int(p.get("attempt") or 0)
                            for p in placements), default=-1) + 1),
        "n_reclaims": len(reclaims),
        "speculated": bool(spec_wins),
        "segments": segments,
        "n_segments": len(segments),
        "totals": {k: totals[k] for k in sorted(totals)},
        # per-segment ranking, biggest consumer first — "which 40 s?"
        "dominant": sorted(totals, key=lambda k: -totals[k]),
        "untraced_s": untraced_s,
        "coverage": (wall - untraced_s) / wall if wall > 0 else 1.0,
    }


def compare(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """Attribute the wall-clock delta between two critical-path reports
    to segments. ``b`` is the candidate/after run, ``a`` the baseline:
    a positive ``delta_s`` means ``b`` spent longer there. Segment rows
    are ranked by absolute delta; ``dominant_segment`` names the largest
    positive contributor (the slowdown's home) and ``share_of_delta`` is
    each segment's fraction of the total wall delta."""
    totals_a = a.get("totals") or {}
    totals_b = b.get("totals") or {}
    delta_wall = _f(b.get("wall_s")) - _f(a.get("wall_s"))
    rows = []
    for name in sorted(set(totals_a) | set(totals_b)):
        da = _f(totals_a.get(name))
        db = _f(totals_b.get(name))
        delta = db - da
        rows.append({
            "name": name,
            "a_s": da,
            "b_s": db,
            "delta_s": delta,
            "share_of_delta": (delta / delta_wall) if delta_wall else None,
        })
    rows.sort(key=lambda r: -abs(r["delta_s"]))
    slower = [r for r in rows if r["delta_s"] > 0]
    return {
        "job_a": a.get("job_id"),
        "job_b": b.get("job_id"),
        "wall_a_s": _f(a.get("wall_s")),
        "wall_b_s": _f(b.get("wall_s")),
        "delta_wall_s": delta_wall,
        "segments": rows,
        "dominant_segment": slower[0]["name"] if slower else None,
    }
