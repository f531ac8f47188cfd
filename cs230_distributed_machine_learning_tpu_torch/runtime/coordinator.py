"""Coordinator: sessions, job fan-out, result collection, aggregation.

Port of the JAX package's ``runtime/coordinator.py`` in its two dispatch
modes. Direct (the default): one process owns the job store and one
in-process executor on the card. Scheduled (``cluster=`` a
ClusterRuntime): the placement engine dispatches subtasks to a pool of
in-process executors and remote agents, and the job loop collects their
results at least once, deduplicated by attempt, with bounded retries and
backoff, poison quarantine (``completed_with_failures``), and stall and
hard deadlines. ``admission_check`` / ``overload_shedding`` cap the
accepted load, and ``journal=True`` replays the store and resumes the
in-flight jobs (``_recover`` / ``resume_inflight``).

The sharded control plane (JAX ``coordinator.py``): ``shard_id`` /
``n_shards`` make the coordinator one shard of N behind stateless front
ends (runtime/frontend.py), with ``s<k>-`` stamped job ids
(``canonical_job_id``), shard-minted session ids that hash home, and a
journal of its own (``journal_dir``). With ``peer_urls`` and
``service.rebalance_enabled`` it rebalances on its pressure signal: a hot
shard migrates a job to a cold peer (``migrate_job`` -> the peer's
``migrate_in``) and offers queued subtasks (``steal_candidates`` /
``release_for_steal``); an idle shard steals them
(``_steal_from_hot_peer``). ``prewarm_hints`` ships the recent job shapes
to a worker that registers; ``_aggregate`` marks the winner the trial
mesh's collective found (``winner_via``).

The job lifecycle mirrors the reference: create a session, stage and
preprocess datasets, expand a train job into per-trial subtasks, run
them, aggregate by ``mean_cv_score`` (best first, ties to the earlier
trial), and refit the winner for its artifact on demand
(``best_model_path``).

An adaptive-search job (``asha`` / ``hyperband``, runtime/search.py) runs
as synchronous rung waves on the in-process executor: each wave's
reports feed the rung controller in the group's order, and its Steps
give the next wave. Learning curves of every result and metrics message
land in the CurveStore (``job_curves`` / ``subtask_curves`` and the
``curve`` events of ``stream_status``); on the metrics path of a search,
the numerical-health watchdog terminates a diverging trial as
``diverged``.

Observability (JAX ``coordinator.py``): each job has one trace id (the
client's, else minted at submit), stamped into every subtask spec, and the
spans ``job.submit`` / ``job.expand`` / ``job.execute`` / ``job.aggregate``
(with ``job.quarantine`` / ``job.retry`` markers in scheduled mode);
``job_cost`` sums the executors' per-batch cost records, ``critical_path``
tiles a job's wall from its spans and flight-recorder timelines, and
``explain`` returns one subtask's timeline. ``health_tick`` derives the
capacity signals and runs the SLO alert rules, on the engine's sweep in
scheduled mode and at every scrape or read.
"""

from __future__ import annotations

import glob
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ..data.datasets import DatasetCache, dataset_dir, find_csv
from ..data.download import download_dataset
from ..data.preprocess import preprocess_dataframe
from ..obs import (
    RECORDER,
    TRACER,
    activate,
    counter_inc,
    current_trace_id,
    flush_journal,
    gauge_set,
    new_trace_id,
    record_event,
    span,
)
from ..obs.curves import CurveStore, divergence
from ..parallel.collectives import best_trial
from ..utils import http
from ..utils.config import FrameworkConfig, get_config
from ..utils.logging import get_logger
from ..utils.serialization import json_safe
from ..utils.torch_setup import DeviceLike, resolve_device
from .artifacts import save_artifact
from .executor import LocalExecutor
from .search import SearchJobDriver, Step
from .store import SUBTASK_TERMINAL_STATUSES, TERMINAL_STATUSES, JobStore
from .subtasks import create_subtasks

logger = get_logger("tpuml.coordinator")

#: the cluster bus topic results arrive on
TOPIC_RESULTS = "result"

#: the value ``_aggregate`` journals under ``winner_via`` when the winner is
#: the trial mesh's collective argmax: the JAX package's value, kept so that
#: either package reads the other's journal (the port's collective runs on
#: torch.distributed, not over ICI)
WINNER_VIA_MESH = "ici_argmax"


class JobMigratedError(Exception):
    """Raised in a job's loop when the rebalancer marked the job for
    migration: the loop unwinds without finalizing (the destination shard
    completes it) and without the failure path (nothing failed)."""


class Coordinator:
    def __init__(
        self,
        config: Optional[FrameworkConfig] = None,
        *,
        device: DeviceLike = None,
        mesh=None,
        executor: Optional[LocalExecutor] = None,
        cluster=None,
        journal: bool = False,
        journal_dir: Optional[str] = None,
        shard_id: Optional[int] = None,
        n_shards: int = 1,
    ):
        """``device`` defaults to the CUDA card and raises when there is
        none; ``device="cpu"`` runs on the host. In scheduled mode
        (``cluster=`` a ClusterRuntime) the jobs run on the cluster's
        workers, and this device only refits winners for their artifacts.
        ``journal=True`` keeps the job store's JSONL journal under the
        storage root, reads back the jobs of an earlier run and resumes the
        ones still in flight (``ready`` is False until that is done).
        ``shard_id`` / ``n_shards`` make it one shard of a sharded control
        plane, whose journal is ``journal_dir`` (``<journal>/shard-<k>``:
        the unit a replacement process takes over). ``mesh`` (a
        ``parallel.mesh.TrialMesh``, 1-D or 2-D) makes the in-process
        executor one rank of that mesh, as JAX's ``Coordinator(mesh=)``
        does: every rank runs its own coordinator and submits the same jobs
        in the same order; the device is the rank's. ``executor=`` brings
        its own mesh, so the two are refused together."""
        if mesh is not None and executor is not None:
            raise ValueError("Coordinator: pass mesh= or executor=, not both (the executor "
                             "carries its own mesh)")
        self.config = config or get_config()
        self.device = mesh.device if mesh is not None and device is None else resolve_device(device)
        self.cluster = cluster
        self.bus = cluster.bus if cluster is not None else None
        self.store = JobStore(journal_dir=(journal_dir or self.config.storage.journal_dir)
                              if journal else None)
        if cluster is not None and cluster.cache is not None:
            self.cache = cluster.cache
        else:
            self.cache = DatasetCache(root=self.config.storage.datasets_dir)
            if cluster is not None:
                cluster.cache = self.cache
        self.executor = executor or LocalExecutor(self.device, cache=self.cache, mesh=mesh)
        self._job_threads: Dict[str, threading.Thread] = {}
        # the winner's subtask spec of each finished job, and its artifact's
        # path once refitted (best_model_path)
        self._artifact_lock = threading.Lock()
        self._artifact_specs: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._artifact_paths: Dict[Tuple[str, str], str] = {}
        #: submit dedupe: client-minted job ids being expanded, so a retried
        #: POST that arrives during the expansion cannot expand twice
        self._submit_lock = threading.Lock()
        self._submitting: set = set()
        #: readiness (GET /readyz): False while the journal is replayed and
        #: in-flight jobs are requeued
        self.ready = not journal
        #: recovery forensics for /healthz and /readyz
        self.recovery: Dict[str, Any] = {}
        #: the supervisor of child agents, when the server runs them
        self.agent_supervisor = None
        # per-trial learning curves, fed by result and metrics ingest; the
        # journaled curves of a read-back journal re-seed it
        self.curves = CurveStore()
        #: this shard's index (None: unsharded) and the fleet's shard count
        self.shard_id = shard_id
        self.n_shards = max(int(n_shards), 1)
        #: peer shard base URLs, index = shard id (server --peers); every
        #: rebalancing path is inert without them
        self.peer_urls: List[str] = []
        #: jobs being quiesced for migration: (sid, jid) -> destination
        self._migrating: Dict[tuple, int] = {}
        self._rebalance_lock = threading.Lock()
        self._rebalance_busy = False
        self._last_rebalance = 0.0
        # the fleet health plane: capacity signals (GET /autoscale) and the
        # SLO alert rules (GET /alerts)
        from ..obs.signals import CapacitySignals
        from ..obs.slo import AlertEngine, default_rules

        self.signals = CapacitySignals(self)
        self.alerts = AlertEngine(default_rules(self.config),
                                  interval_s=self.config.service.alert_eval_interval_s)
        if cluster is not None:
            # journal every attempt issue and every placement, so a replayed
            # coordinator keeps retry budgets and tells dispatched subtasks
            # from never-dispatched ones; speculation sheds first under load
            cluster.ledger.on_attempt = self._journal_attempt
            cluster.engine.on_place = self._journal_placement
            # reshard markers (worker join, death, eviction), so a recovered
            # coordinator resumes the mesh generation
            cluster.engine.on_mesh_change = self._journal_mesh_change
            cluster.engine.shed_check = self.overload_shedding
            cluster.engine.on_sweep_end = self.health_tick
        if journal:
            self._recover()
        else:
            for e in self.store.drain_replayed_curves():
                self.curves.ingest(e["jid"], e["stid"], e["curve"], rung=e["rung"],
                                   attempt=e["attempt"], diverged=e["diverged"])

    def health_tick(self, force: bool = False) -> None:
        """One fleet-health evaluation: the capacity signals, then the
        alert rules. Driven by the engine's sweep (scheduled mode), every
        ``/metrics/prom`` scrape and ``/alerts`` / ``/autoscale`` reads;
        both halves throttle themselves."""
        try:
            self.signals.evaluate(force=force)
        except Exception:  # noqa: BLE001 — health derivation must never break a caller
            logger.exception("Capacity-signal derivation failed")
        try:
            self.alerts.evaluate(force=force)
        except Exception:  # noqa: BLE001
            logger.exception("Alert-rule evaluation failed")
        try:
            self.rebalance_tick()
        except Exception:  # noqa: BLE001 — rebalancing must never break a caller
            logger.exception("Rebalance tick failed")

    # ------------- recovery -------------

    def _recover(self) -> None:
        """Boot-time recovery: surface the store's journal replay, re-seed
        the curves, resume the in-flight jobs, then flip readiness; a
        coordinator never serves half-recovered."""
        t0 = time.time()
        for op, n in self.store.replay_ops.items():
            counter_inc("tpuml_recovery_replayed_ops_total", n, op=op)
        record_event("recovery.start", replayed_ops=sum(self.store.replay_ops.values()),
                     replay_skipped=self.store.replay_skipped)
        if self.cluster is not None and self.store.mesh_generation:
            # resume the reshard counter monotonically: workers that joined
            # during recovery already bumped the live engine
            eng = self.cluster.engine
            with eng._lock:
                eng.mesh_generation = max(eng.mesh_generation, self.store.mesh_generation)
                gauge_set("tpuml_mesh_generation", float(eng.mesh_generation))
                gauge_set("tpuml_mesh_devices_total", float(eng.total_devices()))
        replayed_curves = self.store.drain_replayed_curves()
        for e in replayed_curves:
            self.curves.ingest(e["jid"], e["stid"], e["curve"], rung=e["rung"],
                               attempt=e["attempt"], diverged=e["diverged"])
        resumed = self.resume_inflight()
        recovery_s = time.time() - t0
        self.recovery = {
            "replayed_ops": dict(self.store.replay_ops),
            "replay_skipped": self.store.replay_skipped,
            "jobs_resumed": len(resumed),
            "subtasks_requeued": self._resume_requeued,
            "curves_replayed": len(replayed_curves),
            "recovery_seconds": recovery_s,
        }
        gauge_set("tpuml_coordinator_recovery_seconds", recovery_s)
        record_event("recovery.done", **self.recovery)
        if resumed:
            logger.info("Recovery done in %.3fs: %d jobs resumed, %d subtasks requeued",
                        recovery_s, len(resumed), self._resume_requeued)
        self.ready = True

    def _journal_attempt(self, task: Dict[str, Any], entry, reason: str) -> None:
        sid, jid, stid = task.get("session_id"), task.get("job_id"), task.get("subtask_id")
        if not (sid and jid and stid):
            return
        try:
            self.store.record_attempt(sid, jid, stid, attempt=entry.attempt,
                                      failures=entry.failures, excluded=entry.excluded)
        except KeyError:
            pass  # a job this store never saw: nothing to journal

    def _journal_placement(self, task: Dict[str, Any], worker_id: str,
                           lease_deadline=None) -> None:
        sid, jid, stid = task.get("session_id"), task.get("job_id"), task.get("subtask_id")
        if not (sid and jid and stid):
            return
        try:
            self.store.record_placement(sid, jid, stid, worker_id,
                                        attempt=int(task.get("attempt") or 0),
                                        lease_deadline=lease_deadline)
        except KeyError:
            pass

    #: subtasks re-dispatched by the latest resume_inflight()
    _resume_requeued = 0

    def resume_inflight(self) -> List[str]:
        """Re-dispatch the jobs the journal shows unfinished: replay
        restores state, this restores work. Subtasks with a journaled
        terminal result are not run again. In scheduled mode, a subtask the
        journal shows placed gets a fresh attempt before it is requeued, so
        a zombie worker's late failure is stale while its late completion
        is still accepted (first terminal result wins)."""
        resumed = []
        self._resume_requeued = 0
        for sid, job_id in self.store.unfinished_jobs():
            job = self.store.get_job(sid, job_id)
            specs = [sub["spec"] for sub in job["subtasks"].values()]
            existing = {stid: sub["result"] for stid, sub in job["subtasks"].items()
                        if sub["status"] in SUBTASK_TERMINAL_STATUSES and sub["result"]}
            remaining = [st for st in specs if st["subtask_id"] not in existing]
            if self.cluster is not None:
                for st in remaining:
                    if st.get("placed_worker") is None:
                        continue  # never dispatched
                    self.cluster.ledger.seed(st)
                    self.cluster.ledger.next_attempt(st, reason="recovery")
            logger.info("Resuming job %s: %d/%d subtasks already journaled",
                        job_id, len(existing), len(specs))
            record_event("job.resume", job_id=job_id, n_done=len(existing),
                         n_requeued=len(remaining))
            counter_inc("tpuml_recovery_jobs_resumed_total")
            counter_inc("tpuml_recovery_subtasks_requeued_total", len(remaining))
            self._resume_requeued += len(remaining)
            t = threading.Thread(target=self._run_job, args=(sid, job_id, specs),
                                 kwargs={"existing": existing}, daemon=True)
            self._job_threads[job_id] = t
            t.start()
            resumed.append(job_id)
        return resumed

    # ------------- cross-shard rebalancing -------------
    # A hot shard (high shard pressure) migrates whole jobs to a cold peer
    # and offers queued subtasks to thieves; an idle shard steals. Both ride
    # the crash-safety machinery: journal ops with total replay, attempt
    # fencing, first-terminal-result-wins dedupe (JAX coordinator.py).

    def _journal_mesh_change(self, generation: int, reason: str,
                             snapshot: Dict[str, Any]) -> None:
        try:
            self.store.record_mesh_generation(generation, reason)
        except Exception:  # noqa: BLE001 — journaling must not block resharding
            logger.exception("Mesh-generation journal failed")

    def rebalance_tick(self) -> None:
        """Throttled entry point, driven by ``health_tick``; the pass runs
        on a background thread (it probes its peers over HTTP)."""
        svc = self.config.service
        if (not svc.rebalance_enabled or self.cluster is None or self.shard_id is None
                or not self.peer_urls or not self.ready):
            return
        now = time.time()
        with self._rebalance_lock:
            if self._rebalance_busy or now - self._last_rebalance < svc.rebalance_interval_s:
                return
            self._rebalance_busy = True
            self._last_rebalance = now
        threading.Thread(target=self._rebalance_once, daemon=True).start()

    def _rebalance_once(self) -> None:
        try:
            self._reclaim_stale_steals()
            sig = (self.signals.evaluate() or {}).get("signals") or {}
            my_p = float(sig.get("shard_pressure") or 0.0)
            svc = self.config.service
            if my_p >= svc.rebalance_hot_pressure:
                self._migrate_if_peer_cold(my_p)
            elif my_p <= svc.rebalance_cold_pressure and int(sig.get("idle_workers") or 0) > 0:
                self._steal_from_hot_peer()
        except Exception:  # noqa: BLE001 — a failed pass must not wedge the next
            logger.exception("Rebalance pass failed")
        finally:
            with self._rebalance_lock:
                self._rebalance_busy = False

    def _peer_pressures(self) -> Dict[int, float]:
        """The shard pressure of every answering peer (a dead peer is no
        candidate)."""
        out: Dict[int, float] = {}
        for k, url in enumerate(self.peer_urls):
            if k == self.shard_id or not url:
                continue
            try:
                r = http.request("GET", f"{url}/autoscale", timeout=3)
                if r.status < 400:
                    sig = (r.json() or {}).get("signals") or {}
                    out[k] = float(sig.get("shard_pressure") or 0.0)
            except (*http.TransportError, ValueError):
                continue
        return out

    def _migrate_if_peer_cold(self, my_pressure: float) -> None:
        svc = self.config.service
        peers = self._peer_pressures()
        if not peers:
            return
        dest, cold = min(peers.items(), key=lambda kv: kv[1])
        if cold > svc.rebalance_cold_pressure:
            return
        if cold > 0 and my_pressure / cold < svc.rebalance_imbalance_ratio:
            return  # hot, but not hot enough next to the peer
        picked = self._pick_migratable()
        if picked is not None:
            self.migrate_job(picked[0], picked[1], dest)

    def _pick_migratable(self) -> Optional[tuple]:
        """The cheapest unfinished job that can move: not expanding, not
        migrating, not an adaptive search (its rung state has no export),
        not adopted already (a job migrates at most once). A job with
        nothing at a worker queue's head (nothing running) wins; one that
        is running is the fallback."""
        heads = set()
        if self.cluster is not None:
            for q in self.cluster.engine.queue_snapshot().values():
                if q:
                    heads.add(q[0])
        fallback: Optional[tuple] = None
        for sid, jid in self.store.unfinished_jobs():
            if (sid, jid) in self._migrating:
                continue
            with self._submit_lock:
                if jid in self._submitting:
                    continue
            try:
                job = self.store.get_job(sid, jid)
            except KeyError:
                continue
            subs = job.get("subtasks") or {}
            if any((s.get("spec") or {}).get("asha") for s in subs.values()):
                continue
            if job.get("migrated_from") is not None:
                continue
            live = [stid for stid, s in subs.items()
                    if s["status"] not in SUBTASK_TERMINAL_STATUSES]
            if not live:
                continue
            if not any(stid in heads for stid in live):
                return sid, jid
            if fallback is None:
                fallback = (sid, jid)
        return fallback

    def migrate_job(self, sid: str, job_id: str, dest_shard: int) -> bool:
        """Donor half of the migration state machine (JAX ``migrate_job``):

        1. quiesce: mark the job migrating; its loop unwinds
           (``JobMigratedError``) without finalizing;
        2. fence: bump every open subtask's attempt (journaled) and release
           its engine entry, so no donor copy re-dispatches and a late
           failure is stale (a late completion still wins);
        3. export: POST the whole record to the peer's ``/migrate_in``,
           where the recipient journals ``migrate_in`` first;
        4. stamp: journal ``migrate_out`` only after the peer accepted;
        5. forward: relay late donor-side results to the new owner for
           ``rebalance_forward_s``.

        A failed export aborts and respawns the job here."""
        if self.cluster is None or not self.peer_urls:
            return False
        try:
            url = self.peer_urls[int(dest_shard)]
        except (IndexError, ValueError):
            return False
        record_event("migrate.start", job_id=job_id, dest_shard=int(dest_shard))
        self._migrating[(sid, job_id)] = int(dest_shard)
        try:
            t = self._job_threads.get(job_id)
            if t is not None and t.is_alive():
                t.join(timeout=30.0)
                if t.is_alive():
                    record_event("migrate.abort", job_id=job_id, dest_shard=int(dest_shard),
                                 reason="quiesce_timeout")
                    return False
            job = self.store.get_job(sid, job_id)
            owner = {stid: wid for wid, q in self.cluster.engine.queue_snapshot().items()
                     for stid in q}
            fenced = 0
            for stid, sub in job["subtasks"].items():
                if sub["status"] in SUBTASK_TERMINAL_STATUSES:
                    continue
                task = dict(sub["spec"])
                self.cluster.ledger.seed(task)
                self.cluster.ledger.next_attempt(task, reason="migrate")
                wid = owner.get(stid) or task.get("placed_worker")
                if wid:
                    self.cluster.engine.release_task(wid, stid)
                self.store.clear_steal(stid)
                fenced += 1
            # re-read: the fence journaled fresh attempts into the specs
            job = self.store.get_job(sid, job_id)
            export = {"session_id": sid, "priority": self.store.session_priority(sid),
                      "source_shard": self.shard_id, "job": job}
            try:
                r = http.request("POST", f"{url}/migrate_in", json=json_safe(export),
                                 timeout=30)
            except http.TransportError as e:
                self._abort_migration(sid, job_id, f"peer_unreachable: {e}")
                return False
            if r.status != 200:
                self._abort_migration(sid, job_id, f"peer_rejected: HTTP {r.status}")
                return False
            # holds the window where the recipient has the job and the donor
            # has not stamped it yet open, for crash drills
            delay = float(os.environ.get("CS230_MIGRATE_DELAY_S", 0) or 0)
            if delay > 0:
                time.sleep(delay)
            self.store.record_migrate_out(sid, job_id, int(dest_shard))
            counter_inc("tpuml_jobs_migrated_total", direction="out")
            record_event("migrate.out", job_id=job_id, dest_shard=int(dest_shard),
                         n_fenced=fenced)
            logger.info("Migrated job %s to shard %d (%d subtasks fenced)", job_id,
                        int(dest_shard), fenced)
            pending = [stid for stid, sub in job["subtasks"].items()
                       if sub["status"] not in SUBTASK_TERMINAL_STATUSES]
            self._forward_late_results(job_id, int(dest_shard), pending)
            self.cluster.ledger.forget(list(job["subtasks"]))
            return True
        finally:
            self._migrating.pop((sid, job_id), None)

    def _abort_migration(self, sid: str, job_id: str, reason: str) -> None:
        """A failed export: the job never left. Clear the mark and respawn
        it here; the fenced attempts re-dispatch (as after a restart)."""
        record_event("migrate.abort", job_id=job_id, reason=reason)
        logger.warning("Migration of job %s aborted: %s", job_id, reason)
        self._migrating.pop((sid, job_id), None)
        self._respawn_job(sid, job_id)

    def _respawn_job(self, sid: str, job_id: str) -> None:
        """Resume one job from its store record: run what is not terminal."""
        job = self.store.get_job(sid, job_id)
        specs = [sub["spec"] for sub in job["subtasks"].values()]
        existing = {stid: sub["result"] for stid, sub in job["subtasks"].items()
                    if sub["status"] in SUBTASK_TERMINAL_STATUSES and sub["result"]}
        t = threading.Thread(target=self._run_job, args=(sid, job_id, specs),
                             kwargs={"existing": existing}, daemon=True)
        self._job_threads[job_id] = t
        t.start()

    def _forward_late_results(self, job_id: str, dest_shard: int,
                              pending_ids: List[str]) -> None:
        """Relay late results of a migrated job's open subtasks (zombie
        workers finishing fenced attempts) to the new owner's
        ``/peer_result`` for ``rebalance_forward_s``, once a subtask."""
        if not pending_ids:
            return
        import queue as _q

        url = self.peer_urls[dest_shard]
        wanted = set(pending_ids)
        sub = self.bus.subscribe(TOPIC_RESULTS, key_filter=lambda k: k in wanted)
        deadline = time.time() + self.config.service.rebalance_forward_s

        def _pump():
            done: set = set()
            try:
                while time.time() < deadline and len(done) < len(wanted):
                    try:
                        stid, result = sub.get(timeout=1.0)
                    except _q.Empty:
                        continue
                    if stid in done:
                        continue
                    try:
                        http.request("POST", f"{url}/peer_result",
                                     json=json_safe(result or {}), timeout=10)
                        done.add(stid)
                        counter_inc("tpuml_results_forwarded_total")
                        record_event("migrate.forward", job_id=job_id, subtask_id=stid,
                                     dest_shard=dest_shard)
                    except http.TransportError:
                        logger.warning("Forwarding late result %s to shard %d failed", stid,
                                       dest_shard)
            finally:
                sub.close()

        threading.Thread(target=_pump, daemon=True).start()

    def migrate_in(self, export: Dict[str, Any]) -> Dict[str, Any]:
        """Recipient half: journal the adopted record (before the donor
        stamps ``migrate_out``), then resume it like a recovered job. A
        duplicate export is answered idempotently."""
        if self.cluster is None:
            raise ValueError("job migration requires a clustered coordinator")
        job = (export or {}).get("job") or {}
        sid = (export or {}).get("session_id")
        job_id = job.get("job_id")
        if not (sid and job_id and job.get("subtasks") is not None):
            raise ValueError("malformed migration export")
        if self.store.has_job(sid, job_id):
            return {"status": "accepted", "job_id": job_id, "shard": self.shard_id,
                    "duplicate": True}
        src = export.get("source_shard")
        self.store.create_session(sid, priority=int(export.get("priority") or 0))
        self.store.import_job(sid, job, source_shard=src)
        counter_inc("tpuml_jobs_migrated_total", direction="in")
        record_event("migrate.in", job_id=job_id, source_shard=src,
                     n_subtasks=len(job.get("subtasks") or {}))
        logger.info("Adopted job %s from shard %s (%d subtasks)", job_id, src,
                    len(job.get("subtasks") or {}))
        self._respawn_job(sid, job_id)
        return {"status": "accepted", "job_id": job_id, "shard": self.shard_id}

    # ---- work stealing ----

    def _steal_owner(self) -> Dict[str, str]:
        """Queued, not-head, not-tombstoned subtask -> its worker."""
        tomb = dict(self.store.steal_tombstones)
        return {stid: wid for wid, q in self.cluster.engine.queue_snapshot().items()
                for stid in q[1:] if stid not in tomb}

    def steal_candidates(self) -> Dict[str, Any]:
        """Donor surface (``GET /steal_candidates``): queued subtasks an
        idle peer may pull, offered only while this shard is hot. Queue
        heads (likely running), tombstoned and adaptive-search subtasks
        are withheld; each candidate is priced with its worker's width."""
        out: Dict[str, Any] = {"shard": self.shard_id, "candidates": [],
                               "shard_pressure": None, "backlog_device_seconds": None}
        if self.cluster is None or not self.config.service.rebalance_enabled:
            return out
        sig = (self.signals.report() or {}).get("signals") or {}
        out["shard_pressure"] = sig.get("shard_pressure")
        out["backlog_device_seconds"] = sig.get("backlog_device_seconds")
        if float(sig.get("shard_pressure") or 0.0) < self.config.service.rebalance_hot_pressure:
            return out
        snap = self.cluster.engine.worker_snapshot()
        owner = self._steal_owner()
        for stid, rec in self.store.lookup_specs(list(owner)).items():
            spec = rec["spec"]
            if spec.get("asha"):
                continue
            out["candidates"].append({
                "subtask_id": stid, "job_id": rec["job_id"], "session_id": rec["session_id"],
                "est_s": spec.get("est_s"),
                "n_devices": int((snap.get(owner[stid]) or {}).get("n_devices") or 1),
            })
        return out

    def release_for_steal(self, thief_shard: int, max_n: int,
                          max_n_devices: Optional[int] = None,
                          prefer_wide: bool = False) -> List[Dict[str, Any]]:
        """Donor grant (``POST /steal_tasks``): up to ``max_n`` queued
        subtasks as fresh attempts (fencing the donor's copy), each released
        from its worker and tombstoned (``steal``) so neither a live nor a
        restarted donor re-dispatches it inside the steal lease.
        ``max_n_devices`` drops candidates priced wider than the thief's
        widest idle slice; ``prefer_wide`` grants the widest first."""
        if self.cluster is None or not self.config.service.rebalance_enabled or max_n <= 0:
            return []
        snap = self.cluster.engine.worker_snapshot()
        owner = self._steal_owner()
        width = {stid: int((snap.get(wid) or {}).get("n_devices") or 1)
                 for stid, wid in owner.items()}
        if max_n_devices is not None:
            owner = {stid: wid for stid, wid in owner.items()
                     if width[stid] <= int(max_n_devices)}
        items = sorted(self.store.lookup_specs(list(owner)).items(),
                       key=((lambda kv: (-width.get(kv[0], 1), kv[0])) if prefer_wide
                            else (lambda kv: kv[0])))
        granted: List[Dict[str, Any]] = []
        for stid, rec in items:
            if len(granted) >= int(max_n):
                break
            if rec["spec"].get("asha"):
                continue
            task = dict(rec["spec"])
            self.cluster.ledger.seed(task)
            self.cluster.ledger.next_attempt(task, reason="steal")
            self.cluster.engine.release_task(owner[stid], stid)
            self.store.record_steal(rec["session_id"], rec["job_id"], stid,
                                    thief_shard=int(thief_shard),
                                    attempt=int(task.get("attempt") or 0))
            task["metadata"] = rec["metadata"]
            task["stolen_from"] = self.shard_id
            granted.append(task)
            counter_inc("tpuml_subtasks_stolen_total", direction="out")
            record_event("steal.out", job_id=rec["job_id"], subtask_id=stid,
                         attempt=int(task.get("attempt") or 0), thief_shard=int(thief_shard),
                         n_devices=width.get(stid, 1))
        if granted:
            logger.info("Granted %d queued subtasks to thief shard %d", len(granted),
                        int(thief_shard))
        return granted

    def _steal_from_hot_peer(self) -> None:
        """Thief half: read the peers' ``/steal_candidates``, pull from the
        hottest offering shard what this shard's widest idle slice can
        serve, run the grants here and relay each result to the donor."""
        svc = self.config.service
        widest_idle = 0
        try:
            snap = self.cluster.engine.worker_snapshot()
            for wid, q in self.cluster.engine.queue_snapshot().items():
                if not q:
                    widest_idle = max(widest_idle,
                                      int((snap.get(wid) or {}).get("n_devices") or 1))
        except Exception:  # noqa: BLE001 — a torn snapshot must not crash the sweep
            widest_idle = 0
        if widest_idle <= 0:
            return
        offers: Dict[int, Dict[str, Any]] = {}
        for k, url in enumerate(self.peer_urls):
            if k == self.shard_id or not url:
                continue
            try:
                r = http.request("GET", f"{url}/steal_candidates", timeout=3)
                if r.status < 400:
                    body = r.json() or {}
                    servable = [c for c in (body.get("candidates") or [])
                                if int(c.get("n_devices") or 1) <= widest_idle]
                    if servable:
                        body["candidates"] = servable
                        offers[k] = body
            except (*http.TransportError, ValueError):
                continue
        if not offers:
            return
        donor = max(offers, key=lambda k: float(offers[k].get("shard_pressure") or 0.0))
        try:
            r = http.request("POST", f"{self.peer_urls[donor]}/steal_tasks", json={
                "thief_shard": self.shard_id, "max_n": int(svc.steal_max_tasks),
                "max_n_devices": widest_idle, "prefer_wide": widest_idle > 1,
            }, timeout=10)
            tasks = (r.json() or {}).get("tasks") or [] if r.status < 400 else []
        except (*http.TransportError, ValueError):
            return
        if tasks:
            self._run_stolen(donor, tasks)

    def _run_stolen(self, donor_shard: int, tasks: List[Dict[str, Any]]) -> None:
        """Run stolen grants on this shard's workers and relay the results
        home. The thief journals nothing: if it dies, the donor's steal
        lease reclaims the subtasks with a fencing attempt."""
        import queue as _q

        url = self.peer_urls[donor_shard]
        wanted = {t["subtask_id"] for t in tasks if t.get("subtask_id")}
        sub = self.bus.subscribe(TOPIC_RESULTS, key_filter=lambda k: k in wanted)
        for t in tasks:
            counter_inc("tpuml_subtasks_stolen_total", direction="in")
            record_event("steal.in", job_id=t.get("job_id"), subtask_id=t.get("subtask_id"),
                         attempt=int(t.get("attempt") or 0), donor_shard=donor_shard)
        logger.info("Stole %d queued subtasks from shard %d", len(tasks), donor_shard)
        self.cluster.submit([dict(t) for t in tasks])

        def _pump():
            deadline = time.time() + 20.0 * self.config.service.client_timeout_s
            pending = set(wanted)
            try:
                while pending and time.time() < deadline:
                    try:
                        stid, result = sub.get(timeout=1.0)
                    except _q.Empty:
                        continue
                    if stid not in pending:
                        continue  # an echo of a relayed result: never re-post
                    try:
                        http.request("POST", f"{url}/peer_result",
                                     json=json_safe(result or {}), timeout=10)
                        pending.discard(stid)
                    except http.TransportError:
                        logger.warning("Relaying stolen result %s to shard %d failed", stid,
                                       donor_shard)
            finally:
                sub.close()
                self.cluster.ledger.forget(wanted)

        threading.Thread(target=_pump, daemon=True).start()

    def _reclaim_stale_steals(self) -> None:
        """Donor lease sweep: a tombstone older than ``steal_lease_s`` whose
        subtask is still open means the thief went dark; reclaim it with a
        fresh attempt and dispatch it here."""
        svc = self.config.service
        now = time.time()
        for stid, t in list(self.store.steal_tombstones.items()):
            if now - float(t.get("ts") or 0) < svc.steal_lease_s:
                continue
            self.store.clear_steal(stid)
            info = self.store.lookup_specs([stid])
            if stid not in info:
                continue  # terminal already
            rec = info[stid]
            task = dict(rec["spec"])
            self.cluster.ledger.seed(task)
            self.cluster.ledger.next_attempt(task, reason="steal_reclaim")
            task["metadata"] = rec["metadata"]
            counter_inc("tpuml_subtasks_retried_total", reason="steal_reclaim")
            record_event("steal.reclaim", job_id=rec["job_id"], subtask_id=stid,
                         attempt=int(task.get("attempt") or 0), thief_shard=t.get("thief"))
            logger.warning("Steal lease expired for %s (thief shard %s): reclaimed", stid,
                           t.get("thief"))
            self.cluster.submit([task])

    def ingest_peer_result(self, result: Dict[str, Any]) -> None:
        """``POST /peer_result``: a peer shard hands back a result (a
        thief's stolen grant, or a donor's late result of a migrated job),
        published on the local result topic under the same dedupe and
        stale-attempt rules as any worker result."""
        result = dict(result or {})
        stid = result.get("subtask_id")
        if not stid or self.bus is None:
            return
        counter_inc("tpuml_peer_results_ingested_total")
        self.bus.publish(TOPIC_RESULTS, result, key=stid)

    def canonical_job_id(self, job_id: str) -> str:
        """The id a job is stored and routed under: on a shard, a
        client-minted id gains this shard's ``s<k>-`` stamp
        (deterministically, so a resubmit dedupes); stamped, adopted and
        unsharded ids pass through."""
        if self.shard_id is None or not job_id:
            return job_id
        if self.store.is_adopted_job(job_id):
            return job_id  # keeps the donor's stamp
        from .sharding import stamp_job_id

        return stamp_job_id(self.shard_id, job_id)

    def prewarm_hints(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Prewarm hints for a worker that registers (the ``/subscribe``
        response's ``prewarm``): the latest job shape of each (model family,
        dataset), ranked by the placement engine's hot families, newest
        first within a rank. Empty with ``CS230_PREWARM=0``, under overload
        (counted as shed) or before any job ran."""
        from .prewarm import enabled as prewarm_enabled
        from .prewarm import max_hints

        if not prewarm_enabled():
            return []
        if self.overload_shedding():
            counter_inc("tpuml_overload_shed_total", kind="prewarm")
            return []
        limit = limit if limit is not None else max_hints()
        if limit <= 0:
            return []
        hints: Dict[Any, Dict[str, Any]] = {}
        for job in self.store.jobs_overview():
            family, dataset_id = job.get("model_type"), job.get("dataset_id")
            if not family or not dataset_id or (family, dataset_id) in hints:
                continue
            try:
                shape = self.store.hint_shape(job["session_id"], job["job_id"])
            except Exception:  # noqa: BLE001 — an evicted or foreign job
                continue
            hints[(family, dataset_id)] = {"model_type": family, "dataset_id": dataset_id,
                                           **shape}
        ranked = list(hints.values())
        hot = (self.cluster.engine.hot_families(top_n=max(limit, 5))
               if self.cluster is not None else [])
        rank = {family: i for i, family in enumerate(hot)}
        ranked.sort(key=lambda h: rank.get(h["model_type"], len(rank)))
        return ranked[:limit]

    # ------------- admission control -------------

    def admission_check(self, sid: Optional[str] = None) -> Optional[Dict[str, Any]]:
        """Admission decision for one would-be submit: None when admitted,
        else {reason, retry_after_s, status} for the server's 429 (or 503
        while recovering). Caps: in-flight jobs in all and per session, and
        the pending-subtask watermark."""
        svc = self.config.service
        if not self.ready:
            return {"reason": "recovering", "retry_after_s": svc.admission_retry_after_s,
                    "status": 503}
        counts = self.store.unfinished_counts()
        reason = None
        if 0 < svc.max_inflight_jobs <= counts["jobs"]:
            reason = "global_inflight"
        elif (sid is not None and 0 < svc.max_inflight_jobs_per_session
              <= counts["per_session"].get(sid, 0)):
            reason = "session_inflight"
        elif 0 < svc.admission_queue_watermark <= counts["pending_subtasks"]:
            reason = "queue_depth"
        if reason is None:
            return None
        counter_inc("tpuml_jobs_rejected_total", reason=reason)
        record_event("admission.reject", reason=reason, session_id=sid,
                     inflight_jobs=counts["jobs"], pending_subtasks=counts["pending_subtasks"])
        logger.warning("Rejecting submit for session %s: %s (%d jobs in flight, "
                       "%d subtasks pending)", sid, reason, counts["jobs"],
                       counts["pending_subtasks"])
        return {"reason": reason, "retry_after_s": svc.admission_retry_after_s, "status": 429}

    def overload_shedding(self) -> bool:
        """True while the accepted load is above ``shed_fraction`` of an
        enabled cap: the band where the engine sheds optional work
        (speculative duplicates) before admission rejects submits."""
        svc = self.config.service
        frac = svc.shed_fraction
        if frac <= 0:
            return False
        counts = self.store.unfinished_counts()
        if svc.max_inflight_jobs > 0 and counts["jobs"] >= frac * svc.max_inflight_jobs:
            return True
        return (svc.admission_queue_watermark > 0
                and counts["pending_subtasks"] >= frac * svc.admission_queue_watermark)

    def predictor_calibration(self) -> Dict[str, Any]:
        """Per-family predicted-vs-actual calibration of the runtime
        predictor (``GET /predictor/calibration``); empty in direct mode."""
        families: Dict[str, Any] = {}
        if self.cluster is not None:
            report = getattr(self.cluster.engine.predictor, "calibration_report", None)
            if report is not None:
                families = report()
        return {"families": families, "n_families": len(families)}

    def create_session(self, session_id: Optional[str] = None, *, priority: int = 0) -> str:
        """``priority`` is the session's QoS lane, kept in the session
        record and its journal line (JAX ``create_session``). A shard that
        mints the id itself mints one that hashes to it, so the front ends
        route the session here."""
        if session_id is None and self.shard_id is not None:
            from .sharding import shard_of

            while True:
                session_id = str(uuid.uuid4())
                if shard_of(session_id, self.n_shards) == self.shard_id:
                    break
        return self.store.create_session(session_id, priority=priority)

    # ------------- data -------------

    def download_data(self, sid: str, dataset_url: str, dataset_name: str,
                      dataset_type: str) -> Dict[str, Any]:
        """Stage a dataset (kaggle, huggingface, local or builtin)."""
        self._require_session(sid)
        path = download_dataset(dataset_url, dataset_name, dataset_type,
                                root=self.config.storage.datasets_dir)
        self.cache.invalidate(dataset_name)
        return {"status": "success", "dataset_path": path}

    def check_data(self, sid: str, dataset_name: str) -> Dict[str, Any]:
        self._require_session(sid)
        path = find_csv(dataset_name, root=self.config.storage.datasets_dir)
        return {"exists": path is not None, "path": path}

    def preprocess(self, sid: str, dataset_id: str,
                   config: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Run the preprocessing pipeline on a staged raw dataset and stage
        the result as its preprocessed CSV. ``config`` is the pipeline's
        dict; None reads ``<configs_dir>/<dataset_id>/*.yaml`` (needs
        PyYAML)."""
        self._require_session(sid)
        import pandas as pd

        csv = find_csv(dataset_id, root=self.config.storage.datasets_dir)
        if csv is None:
            raise FileNotFoundError(f"Dataset {dataset_id!r} not staged")
        if config is None:
            import yaml

            hits = sorted(glob.glob(
                os.path.join(self.config.storage.configs_dir, dataset_id, "*.yaml")))
            if not hits:
                raise FileNotFoundError(f"No preprocess config for {dataset_id!r}")
            with open(hits[0]) as f:
                config = yaml.safe_load(f.read())
        df = preprocess_dataframe(pd.read_csv(csv), config)
        out_dir = os.path.join(dataset_dir(dataset_id, self.config.storage.datasets_dir),
                               "preprocessed")
        os.makedirs(out_dir, exist_ok=True)
        out_path = os.path.join(out_dir, f"{dataset_id}_preprocessed.csv")
        df.to_csv(out_path, index=False)
        self.cache.invalidate(dataset_id)
        return {"status": "success", "preprocessed_path": out_path, "n_rows": len(df)}

    # ------------- training -------------

    def submit_train(self, sid: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Expand a train job into subtasks, persist, and run it on a
        background thread. Payload: {job_id?, dataset_id, model_details,
        train_params, priority?}. A resubmit of a client-minted job id
        (a retried POST, a resumed event stream) returns the first
        acceptance with ``duplicate: true`` and never expands again."""
        self._require_session(sid)
        if not payload.get("job_id"):
            return self._submit_train_locked(sid, self.canonical_job_id(str(uuid.uuid4())),
                                             payload)
        job_id = self.canonical_job_id(payload["job_id"])
        with self._submit_lock:
            known = self.store.has_job(sid, job_id)
            if known or job_id in self._submitting:
                return {
                    "status": "submitted",
                    "job_id": job_id,
                    # unknown while the first copy is still expanding
                    "total_subtasks": (self.store.job_progress(sid, job_id)["total_subtasks"]
                                       if known else None),
                    "duplicate": True,
                }
            self._submitting.add(job_id)
        try:
            return self._submit_train_locked(sid, job_id, payload)
        finally:
            with self._submit_lock:
                self._submitting.discard(job_id)

    def _submit_train_locked(self, sid: str, job_id: str,
                             payload: Dict[str, Any]) -> Dict[str, Any]:
        dataset_id = payload["dataset_id"]
        model_details = payload["model_details"]
        train_params = dict(payload.get("train_params") or {})
        cv_params = model_details.get("cv_params") or {}
        if "cv" in cv_params and "cv" not in train_params:
            train_params["cv"] = cv_params["cv"]
        scoring = train_params.get("scoring", cv_params.get("scoring"))
        if callable(scoring) and not isinstance(scoring, str) and self.cluster is not None:
            # a cluster's agents pull tasks over REST, where a function
            # cannot travel: fail the submission with the reason
            raise ValueError(
                "callable scoring is not supported on a clustered coordinator (tasks are "
                "serialized to worker agents); use a scorer name, or a coordinator "
                "without a cluster")
        # one trace id a job: the client's (X-Trace-Id, or an activate() in
        # local mode), else minted here; stamped into every spec, so it
        # rides the task bus and /next_tasks to the agents
        trace_id = current_trace_id() or new_trace_id()
        TRACER.bind_job(job_id, trace_id)
        with span("job.submit", trace_id=trace_id, job_id=job_id, dataset_id=dataset_id,
                  model_type=model_details.get("model_type")) as sub_sp:
            with span("job.expand", job_id=job_id):
                subtasks = create_subtasks(job_id, sid, dataset_id, model_details,
                                           train_params)
            priority = None
            if self.cluster is not None:
                # the QoS lane rides every spec (payload first, else the
                # session's): the dispatch queues order on it, and retries
                # and requeues copy the spec, so the lane survives them
                priority = payload.get("priority")
                if priority is None:
                    priority = self.store.session_priority(sid)
            for st in subtasks:
                st["trace_id"] = trace_id
                if priority is not None:
                    st["priority"] = int(priority or 0)
            sub_sp.attrs["total_subtasks"] = len(subtasks)
            try:
                metadata = self.cache.metadata(dataset_id)
            except FileNotFoundError:
                metadata = {}
            self.store.create_job(sid, job_id, payload, subtasks, metadata)
        counter_inc("tpuml_jobs_submitted_total")
        t = threading.Thread(target=self._run_job, args=(sid, job_id, subtasks), daemon=True)
        self._job_threads[job_id] = t
        t.start()
        return {"status": "submitted", "job_id": job_id, "total_subtasks": len(subtasks)}

    def _run_job(self, sid: str, job_id: str, subtasks: List[Dict[str, Any]],
                 existing: Optional[Dict[str, Dict[str, Any]]] = None) -> None:
        """Execute a job's subtasks and aggregate; any error fails the job.
        ``existing`` (the resume path) maps the subtasks already finished to
        their journaled results; only the rest run. A job whose specs carry
        an ``asha`` block goes through the rung controller."""

        def on_result(subtask_id: str, status: str, result: Optional[Dict[str, Any]]):
            self.store.update_subtask(sid, job_id, subtask_id, status, result)
            r = result or {}
            if isinstance(r.get("curve"), dict):
                # verdict only: this result is terminal already
                self.ingest_curve(sid, job_id, subtask_id, r["curve"],
                                  rung=int((r.get("asha") or {}).get("rung") or 0),
                                  attempt=int(r.get("attempt") or 0))
            record_event("result", job_id=job_id, subtask_id=subtask_id,
                         worker_id=r.get("worker_id"),
                         attempt=int(r.get("attempt") or 0), status=status,
                         mean_cv_score=r.get("mean_cv_score"), error=r.get("error"))

        def on_metrics(msg: Dict[str, Any]):
            if isinstance(msg.get("curve"), dict):
                # live ingest at the group boundary, before the result settles
                self.ingest_curve(sid, job_id, msg.get("subtask_id"), msg["curve"],
                                  rung=int(msg.get("rung") or 0),
                                  attempt=int(msg.get("attempt") or 0))

        def on_intermediate(subtask_id: str, result: Optional[Dict[str, Any]]):
            # a non-terminal rung boundary (promoted or paused): journal the
            # report and its curve, no terminal transition
            self.store.update_subtask(sid, job_id, subtask_id, "promoted", result)
            r = result or {}
            if isinstance(r.get("curve"), dict):
                self.ingest_curve(sid, job_id, subtask_id, r["curve"],
                                  rung=int((r.get("asha") or {}).get("rung") or 0),
                                  attempt=int(r.get("attempt") or 0))
            record_event("result", job_id=job_id, subtask_id=subtask_id,
                         worker_id=r.get("worker_id"),
                         attempt=int(r.get("attempt") or 0), status="promoted",
                         mean_cv_score=r.get("mean_cv_score"),
                         rung=(r.get("asha") or {}).get("rung"))

        existing = existing or {}
        remaining = [st for st in subtasks if st["subtask_id"] not in existing]
        driver: Optional[SearchJobDriver] = None
        if any(st.get("asha") for st in subtasks):
            driver = SearchJobDriver(subtasks)
            # rebuild rung state from the journaled rung history (a no-op on
            # a fresh job; a resumed job re-derives its promotions)
            driver.resume(self.store.get_job(sid, job_id))
        # a job thread starts with an empty context: re-activate the trace
        # the specs carry (journaled specs keep it, so a resumed job
        # stitches into the same trace)
        trace_id = next((st.get("trace_id") for st in subtasks if st.get("trace_id")),
                        None) or TRACER.trace_for_job(job_id) or new_trace_id()
        TRACER.bind_job(job_id, trace_id)
        try:
            by_id: Dict[str, Optional[Dict[str, Any]]] = dict(existing)
            with activate(trace_id):
                with span("job.execute", trace_id=trace_id, job_id=job_id,
                          n_subtasks=len(remaining), n_resumed=len(existing),
                          search="asha" if driver is not None else None,
                          mode="scheduled" if self.cluster is not None else "direct"):
                    if driver is not None:
                        if self.cluster is not None:
                            by_id.update(self._run_job_search_scheduled(
                                sid, job_id, driver, on_result, on_intermediate))
                        else:
                            by_id.update(self._run_job_search_direct(
                                sid, job_id, driver, on_result, on_intermediate, on_metrics))
                    elif remaining:
                        if self.cluster is not None:
                            new_results = self._run_job_scheduled(sid, job_id, remaining,
                                                                  on_result)
                        else:
                            new_results = self.executor.run_subtasks(
                                remaining, on_result=on_result, on_metrics=on_metrics)
                        for st, r in zip(remaining, new_results):
                            by_id[st["subtask_id"]] = r
                results = [by_id.get(st["subtask_id"]) for st in subtasks]
                with span("job.aggregate", trace_id=trace_id, job_id=job_id):
                    self._aggregate(sid, job_id, results, subtasks,
                                    search_summary=(driver.summary() if driver is not None
                                                    else None))
            counter_inc("tpuml_jobs_completed_total")
        except JobMigratedError:
            # not a failure: the job left this shard; migrate_job owns the
            # handoff and the destination shard finalizes it
            logger.info("Job %s quiesced for migration", job_id)
        except Exception as e:  # noqa: BLE001 — the job thread's boundary
            logger.exception("Job %s failed", job_id)
            counter_inc("tpuml_jobs_failed_total")
            flush_journal()
            self.store.finalize_job(sid, job_id, {"status": "failed", "error": str(e)})

    # ------------- scheduled mode -------------

    def _quarantine(self, job_id: str, stid: str, result: Dict[str, Any], entry,
                    poisoned: bool) -> Dict[str, Any]:
        """The quarantined form of a failed result (retry budget spent, or
        the subtask killed too many worker backends), counted and recorded."""
        quarantined = {**result, "quarantined": True, "attempts": entry.failures,
                       "quarantine_reason": "poisoned" if poisoned else "retries_exhausted"}
        counter_inc("tpuml_subtasks_quarantined_total")
        logger.error("Quarantining %s after %d failed attempts (%s): %s", stid,
                     entry.failures, quarantined["quarantine_reason"], result.get("error"))
        with span("job.quarantine", job_id=job_id, subtask_id=stid, attempts=entry.failures,
                  reason=quarantined["quarantine_reason"]):
            pass
        record_event("quarantine", job_id=job_id, subtask_id=stid,
                     worker_id=result.get("worker_id"),
                     attempt=int(result.get("attempt") or 0),
                     reason=quarantined["quarantine_reason"], attempts=entry.failures,
                     device_losses=entry.device_losses, error=result.get("error"))
        return quarantined

    def _retry_task(self, job_id: str, stid: str, spec: Dict[str, Any],
                    result: Dict[str, Any], entry) -> tuple:
        """A failed attempt's retry: a fresh attempt that excludes the
        failing worker, due after the exponential backoff. Returns (due
        time, task)."""
        cfg = self.config.scheduler
        wid = result.get("worker_id")
        task = dict(spec)
        task.pop("speculative", None)
        self.cluster.ledger.next_attempt(task, exclude_worker=wid, reason="failure")
        backoff = min(cfg.retry_backoff_s * 2 ** max(entry.failures - 1, 0),
                      cfg.retry_backoff_max_s)
        counter_inc("tpuml_subtasks_retried_total", reason="failure")
        logger.warning("Retrying %s (attempt %d/%d) in %.2fs, excluding worker %s", stid,
                       task["attempt"], cfg.retry_max_attempts, backoff, wid)
        with span("job.retry", job_id=job_id, subtask_id=stid, attempt=task["attempt"],
                  backoff_s=backoff, excluded_worker=wid):
            pass
        record_event("retry", job_id=job_id, subtask_id=stid, worker_id=wid,
                     attempt=task["attempt"], reason="failure", backoff_s=backoff,
                     failures=entry.failures, max_attempts=cfg.retry_max_attempts,
                     error=result.get("error"))
        return time.time() + backoff, task

    def _await_result(self, sub, pending: set, retry_due: List[tuple], clock: Dict[str, float],
                      metadata) -> Optional[tuple]:
        """One wait of a scheduled loop: submit the retries that came due,
        then wait up to 0.5 s for a result. None on a quiet wait. Raises
        TimeoutError past the hard deadline (20 x ``client_timeout_s``), or
        when no result came for ``client_timeout_s`` and no live worker
        holds any pending subtask (progress-aware, not a wall clock)."""
        import queue as _q

        stall_grace = self.config.service.client_timeout_s
        now = time.time()
        if now > clock["hard_deadline"]:
            raise TimeoutError(f"{len(pending)} subtasks unfinished at the hard deadline "
                               f"({20.0 * stall_grace:.0f}s)")
        due = [t for ts, t in retry_due if ts <= now]
        if due:
            retry_due[:] = [(ts, t) for ts, t in retry_due if ts > now]
            self.cluster.submit(due, metadata=metadata)
        try:
            return sub.get(timeout=0.5)
        except _q.Empty:
            if time.time() - clock["last_progress"] > stall_grace:
                owned = {t["subtask_id"] for _, t in retry_due}
                for q in self.cluster.engine.queue_snapshot().values():
                    owned.update(q)
                if not (pending & owned):
                    raise TimeoutError(
                        f"{len(pending)} subtasks stalled with no live owner for "
                        f"{stall_grace:.0f}s (e.g. {sorted(pending)[:3]})")
                clock["last_progress"] = time.time()  # workers still own tasks
            return None

    def _run_job_scheduled(self, sid, job_id, subtasks, on_result) -> List[Dict[str, Any]]:
        """Dispatch through the placement engine and collect the results
        from the bus, with the fault-tolerance layer: the first terminal
        non-failed result of a subtask wins and later copies (requeue races,
        a speculative loser, a zombie attempt) are dropped; a failure counts
        against the retry budget only when it is the current attempt's, and
        is retried after its backoff on another worker up to
        ``retry_max_attempts`` executions; a subtask that spent its budget,
        or killed ``poison_kill_threshold`` worker backends, is quarantined
        and the job completes with partial results."""
        cfg = self.config.scheduler
        ledger = self.cluster.ledger
        wanted = {st["subtask_id"]: i for i, st in enumerate(subtasks)}
        spec_by_id = {st["subtask_id"]: st for st in subtasks}
        results: List[Optional[Dict[str, Any]]] = [None] * len(subtasks)
        retry_due: List[tuple] = []
        sub = self.bus.subscribe("result", key_filter=lambda k: k in wanted)
        try:
            metadata = self.store.get_job(sid, job_id).get("metadata") or None
            for st in subtasks:
                ledger.seed(st)
            self.cluster.submit(subtasks, metadata=metadata)
            pending = set(wanted)
            clock = {"last_progress": time.time(),
                     "hard_deadline": time.time() + 20.0 * self.config.service.client_timeout_s}
            while pending:
                # the quiesce gate: the rebalancer marked the job for
                # migration; unwind without finalizing
                if self._migrating.get((sid, job_id)) is not None:
                    raise JobMigratedError(job_id)
                got = self._await_result(sub, pending, retry_due, clock, metadata)
                if got is None:
                    continue
                stid, result = got
                result = result or {}
                if stid not in pending:
                    counter_inc("tpuml_results_duplicate_dropped_total")
                    record_event("result.duplicate", job_id=job_id, subtask_id=stid,
                                 worker_id=result.get("worker_id"),
                                 attempt=int(result.get("attempt") or 0))
                    if ledger.was_speculated(stid):
                        counter_inc("tpuml_speculative_wasted_total")
                    continue
                if result.get("status", "completed") != "failed":
                    pending.discard(stid)
                    ledger.mark_done(stid)
                    results[wanted[stid]] = result
                    if result.get("speculative"):
                        counter_inc("tpuml_speculative_won_total")
                    on_result(stid, "completed", result)
                    clock["last_progress"] = time.time()
                    continue
                attempt = int(result.get("attempt") or 0)
                if ledger.is_stale(stid, attempt):
                    # a newer attempt owns the subtask: this failure burns nothing
                    record_event("result.stale", job_id=job_id, subtask_id=stid,
                                 worker_id=result.get("worker_id"), attempt=attempt,
                                 error=result.get("error"))
                    continue
                entry = ledger.record_failure(stid, result.get("worker_id"))
                poisoned = entry.device_losses >= cfg.poison_kill_threshold
                if poisoned or entry.failures >= cfg.retry_max_attempts:
                    quarantined = self._quarantine(job_id, stid, result, entry, poisoned)
                    pending.discard(stid)
                    ledger.mark_done(stid)
                    results[wanted[stid]] = quarantined
                    on_result(stid, "failed", quarantined)
                else:
                    retry_due.append(self._retry_task(job_id, stid, spec_by_id[stid], result,
                                                      entry))
                clock["last_progress"] = time.time()
            return results  # type: ignore[return-value]
        finally:
            sub.close()
            ledger.forget(wanted)

    def _apply_search_step(self, step: Step, job_id, pending, results_by_id, on_result,
                           on_intermediate, metadata) -> None:
        """Apply one rung-controller step to the scheduled loop: journal the
        promoted reports first, then issue the cancels, finalize the
        terminals, and submit the fresh rung dispatches last, so a crash
        between two phases replays into a state the resume path handles."""
        ledger = self.cluster.ledger
        for tid, res in step.promoted:
            if res is not None:
                on_intermediate(tid, res)
        new_tasks = []
        for task in step.new_tasks:
            task.pop("speculative", None)
            ledger.next_attempt(task, reason="promotion")
            new_tasks.append(task)
        for c in step.cancels:
            self.cluster.cancel_subtask(c["subtask_id"], c.get("attempt", 0), job_id=job_id)
        for tid, status, res in step.finished:
            pending.discard(tid)
            ledger.mark_done(tid)
            results_by_id[tid] = res
            on_result(tid, status, res)
            # the cancel registry is not cleared here: a prune's terminal
            # lands in the same step as its cancel, before any agent polled
        if new_tasks:
            self.cluster.submit(new_tasks, metadata=metadata)

    def _run_job_search_scheduled(self, sid, job_id, driver: SearchJobDriver, on_result,
                                  on_intermediate) -> Dict[str, Dict[str, Any]]:
        """The scheduled rung loop: ``_run_job_scheduled``'s ingest (dedup,
        retries, quarantine), with each result fed to the rung controller,
        which may promote its trial (a fresh attempt at eta times the
        budget), pause it, or prune its peers; a quarantined trial leaves
        the ladder so its rungs close for the others."""
        cfg = self.config.scheduler
        ledger = self.cluster.ledger
        all_ids = set(driver.specs)
        results_by_id: Dict[str, Dict[str, Any]] = {}
        pending = {tid for tid in all_ids if tid not in driver._finalized}
        retry_due: List[tuple] = []
        sub = self.bus.subscribe("result", key_filter=lambda k: k in all_ids)

        def apply(step):
            self._apply_search_step(step, job_id, pending, results_by_id, on_result,
                                    on_intermediate, metadata)
            self.store.set_search_state(sid, job_id, driver.summary())

        try:
            metadata = self.store.get_job(sid, job_id).get("metadata") or None
            # resume: terminal states the replayed controller derived whose
            # store writes a crash swallowed
            apply(driver.resume_step())
            tasks = driver.pending_tasks()
            for st in tasks:
                ledger.seed(st)
            if tasks:
                self.cluster.submit(tasks, metadata=metadata)
            clock = {"last_progress": time.time(),
                     "hard_deadline": time.time() + 20.0 * self.config.service.client_timeout_s}
            while pending:
                got = self._await_result(sub, pending, retry_due, clock, metadata)
                if got is None:
                    continue
                stid, result = got
                result = result or {}
                if stid not in pending:
                    counter_inc("tpuml_results_duplicate_dropped_total")
                    record_event("result.duplicate", job_id=job_id, subtask_id=stid,
                                 worker_id=result.get("worker_id"),
                                 attempt=int(result.get("attempt") or 0))
                    continue
                status = result.get("status", "completed")
                if status != "failed":
                    # a rung report or a cooperative-cancel terminal: both
                    # feed the controller, which drops stale deliveries
                    curve = result.get("curve")
                    if status == "pruned":
                        step = driver.handle_pruned_result(stid, result)
                    elif isinstance(curve, dict) and self.ingest_curve(
                            sid, job_id, stid, curve,
                            rung=int((result.get("asha") or {}).get("rung") or 0),
                            attempt=int(result.get("attempt") or 0)):
                        # the watchdog: a diverging trial ends as diverged
                        step = driver.handle_diverged(stid, curve, result=result)
                    else:
                        step = driver.handle_result(stid, result)
                    apply(step)
                    clock["last_progress"] = time.time()
                    continue
                attempt = int(result.get("attempt") or 0)
                if ledger.is_stale(stid, attempt):
                    record_event("result.stale", job_id=job_id, subtask_id=stid,
                                 worker_id=result.get("worker_id"), attempt=attempt,
                                 error=result.get("error"))
                    continue
                entry = ledger.record_failure(stid, result.get("worker_id"))
                poisoned = entry.device_losses >= cfg.poison_kill_threshold
                if poisoned or entry.failures >= cfg.retry_max_attempts:
                    apply(driver.handle_quarantine(
                        stid, self._quarantine(job_id, stid, result, entry, poisoned)))
                else:
                    due, task = self._retry_task(job_id, stid, driver.specs[stid], result,
                                                 entry)
                    # the driver's spec follows the live attempt, so a later
                    # prune's cancel carries this attempt
                    driver.specs[stid] = task
                    retry_due.append((due, task))
                clock["last_progress"] = time.time()
            return results_by_id
        finally:
            sub.close()
            ledger.forget(all_ids)
            self.cluster.clear_cancels(all_ids)

    def _apply_search_step_direct(self, step: Step, results_by_id, on_result,
                                  on_intermediate) -> List[Dict[str, Any]]:
        """Apply one Step; returns the fresh rung dispatches for the next
        wave."""
        for tid, res in step.promoted:
            if res is not None:
                on_intermediate(tid, res)
        new_tasks = []
        for task in step.new_tasks:
            # no attempt ledger in direct mode: bump the attempt stamp so rung
            # dispatches stay distinguishable in results and journals
            task["attempt"] = int(task.get("attempt") or 0) + 1
            task.pop("speculative", None)
            new_tasks.append(task)
        if step.cancels:
            self.executor.cancel(step.cancels)
        for tid, status, res in step.finished:
            results_by_id[tid] = res
            on_result(tid, status, res)
        return new_tasks

    def _run_job_search_direct(self, sid, job_id, driver: SearchJobDriver, on_result,
                               on_intermediate, on_metrics) -> Dict[str, Dict[str, Any]]:
        """The rung loop: synchronous waves on the in-process executor. The
        executor's metrics messages carry each rung's score and curve;
        during a wave they feed the watchdog and the stop_score fast path,
        so cancels reach the executor before its next group boundary.
        After the wave, each result feeds the controller in the wave's
        order. Failures are terminal (no retries) and drop the trial off
        its ladder."""
        results_by_id: Dict[str, Dict[str, Any]] = {}
        self._apply_search_step_direct(driver.resume_step(), results_by_id, on_result,
                                       on_intermediate)
        tasks = driver.pending_tasks()
        while tasks:
            steps: List[Step] = []

            def _metrics(msg):
                curve = msg.get("curve")
                stid_m = msg.get("subtask_id")
                if isinstance(curve, dict) and stid_m:
                    # the watchdog on the metrics path: a diverged trial ends
                    # now instead of burning the rest of its rung budget
                    if self.ingest_curve(sid, job_id, stid_m, curve,
                                         rung=int(msg.get("rung") or 0),
                                         attempt=int(msg.get("attempt") or 0)):
                        dstep = driver.handle_diverged(stid_m, curve, result=None)
                        if dstep.cancels:
                            self.executor.cancel(dstep.cancels)
                        if dstep.finished or dstep.new_tasks or dstep.promoted:
                            steps.append(dstep)
                step = driver.handle_metrics(msg)
                if step.cancels:
                    self.executor.cancel(step.cancels)
                if step.finished or step.new_tasks or step.promoted:
                    steps.append(step)
                on_metrics(msg)

            wave = self.executor.run_subtasks(tasks, on_metrics=_metrics)
            for st, r in zip(tasks, wave):
                stid = st["subtask_id"]
                r = r or {}
                status = r.get("status", "completed")
                if status == "failed":
                    steps.append(driver.handle_quarantine(stid, r))
                elif status == "pruned":
                    steps.append(driver.handle_pruned_result(stid, r))
                else:
                    steps.append(driver.handle_result(stid, r))
            tasks = []
            for step in steps:
                tasks.extend(self._apply_search_step_direct(step, results_by_id, on_result,
                                                            on_intermediate))
            self.store.set_search_state(sid, job_id, driver.summary())
        if not driver.done():
            logger.warning("Search job %s: wave loop drained with %d trials undecided",
                           job_id, sum(1 for t in driver.specs
                                       if t not in driver.controller.decided))
        return results_by_id

    def _aggregate(self, sid, job_id, results, subtasks,
                   search_summary: Optional[Dict[str, Any]] = None) -> None:
        """Completed trials sorted by mean_cv_score, best first; the
        winner is the first trial with the highest score. The winner's
        subtask spec is kept for its artifact, which is refitted lazily, on
        the first ``best_model_path`` (the reference pickled every trial's
        model, ``worker.py:352-356``: pure overhead for a search). An
        adaptive-search winner is refitted at its final rung's parameters.
        Pruned and diverged trials are separate, non-failure reports."""
        completed = [r for r in results if r and r.get("status") == "completed"]
        failed = [r for r in results if r and r.get("status") == "failed"]
        pruned = [r for r in results if r and r.get("status") == "pruned"]
        diverged = [r for r in results if r and r.get("status") == "diverged"]

        def score_key(r):
            v = r.get("mean_cv_score")
            return v if isinstance(v, (int, float)) else float("-inf")

        best = None
        if completed:
            idx, _ = best_trial([score_key(r) for r in completed])
            best = dict(completed[idx])
            # the winner by the trial mesh's collective argmax: each sharded
            # group marks its winner (device_argmax) and the host only
            # combines the marked few; a near-tie that ranks another way
            # on the host keeps the host's winner (JAX coordinator.py)
            marked = [r for r in completed if r.get("device_argmax")]
            if marked:
                dev_best = max(marked, key=score_key)
                if dev_best["subtask_id"] == best["subtask_id"]:
                    best["winner_via"] = WINNER_VIA_MESH
                else:
                    logger.info("device argmax winner %s (%.6f) differs from the host-ranked "
                                "%s (%.6f); keeping the host winner", dev_best["subtask_id"],
                                score_key(dev_best), best["subtask_id"], score_key(best))
            st = next(s for s in subtasks if s["subtask_id"] == best["subtask_id"])
            if best.get("asha") and best.get("parameters"):
                # the subtask list still holds the rung-0 spec
                st = {**st, "parameters": best["parameters"]}
            with self._artifact_lock:
                self._artifact_specs[(sid, job_id)] = st
        final = {
            "results": sorted(completed, key=score_key, reverse=True),
            "failed": failed,
            "best_result": best,
            "completion_time": time.time(),
        }
        if pruned or search_summary is not None:
            final["pruned_results"] = sorted(pruned, key=score_key, reverse=True)
            final["n_pruned"] = len(pruned)
            if search_summary is not None:
                final["search"] = search_summary
        if diverged:
            final["diverged_results"] = diverged
            final["n_diverged"] = len(diverged)
        # the scheduled runtime's quarantine contract: the subtasks the
        # retry layer gave up on form a report, and the job finalizes as
        # ``completed_with_failures``; direct-mode failures carry no
        # quarantine stamp and keep ``completed`` with a failed list
        quarantined = [r for r in failed if r.get("quarantined")]
        if quarantined:
            final["failed_subtasks"] = [
                {"subtask_id": r.get("subtask_id"), "attempts": r.get("attempts"),
                 "reason": r.get("quarantine_reason"), "error": r.get("error")}
                for r in quarantined]
            logger.warning("Job %s completed with %d quarantined subtasks", job_id,
                           len(quarantined))
        flush_journal()  # the job's events are on disk once it reads as done
        self.store.finalize_job(sid, job_id, final)

    # ------------- learning curves -------------

    def ingest_curve(self, sid: str, job_id: str, subtask_id: str, curve: Dict[str, Any],
                     *, rung: int = 0, attempt: int = 0) -> bool:
        """Ingest one trial's curve record and return the watchdog's
        divergence verdict. The store dedups on (subtask, rung, attempt),
        so a curve delivered by both the metrics and the result transport
        counts, journals and records its event once; the caller decides
        whether the verdict ends the trial (search loops do)."""
        if not isinstance(curve, dict) or not subtask_id:
            return False
        diverged = divergence(curve, self.config.service.curve_divergence_factor)
        added = self.curves.ingest(job_id, subtask_id, curve, rung=rung, attempt=attempt,
                                   diverged=diverged)
        if added:
            counter_inc("tpuml_curve_points_total", float(added))
            record_event("curve.ingest", job_id=job_id, subtask_id=subtask_id,
                         rung=int(rung or 0), attempt=int(attempt or 0), n_points=added,
                         diverged=diverged)
            try:
                self.store.record_curve(sid, job_id, subtask_id, curve, rung=rung,
                                        attempt=attempt, diverged=diverged)
            except KeyError:
                pass  # an unknown job: serve from memory only
        return diverged

    def job_curves(self, job_id: str) -> Optional[Dict[str, Any]]:
        """Every recorded curve of a job, joined with its live status; None
        when the job id is unknown, an empty ``curves`` list when it has
        none yet."""
        sid = self.store.session_of(job_id)
        if sid is None:
            return None
        progress = self.store.job_progress(sid, job_id)
        out = self.curves.job(job_id) or {"job_id": job_id, "n_curves": 0, "curves": []}
        out["job_status"] = progress.get("job_status")
        out["tasks_diverged"] = progress.get("tasks_diverged", 0)
        return out

    def subtask_curves(self, job_id: str, subtask_id: str) -> Dict[str, Any]:
        """One trial's curves across rungs and attempts; KeyError when the
        pair never reported one."""
        out = self.curves.subtask(job_id, subtask_id)
        if out is None:
            raise KeyError(f"no curves recorded for subtask {subtask_id!r} of job {job_id!r}")
        return out

    # ------------- status / metrics -------------

    def check_status(self, sid: str, job_id: str) -> Dict[str, Any]:
        self._require_session(sid)
        progress = self.store.job_progress(sid, job_id)
        status = progress["job_status"]
        if status in ("completed", "completed_with_failures") and progress["job_result"]:
            result = progress["job_result"]
            out = {"job_status": status, "job_result": result}
            if result.get("results") and len(result["results"]) > 1:
                out["best_result"] = result.get("best_result")
            if result.get("failed_subtasks"):
                out["failed_subtasks"] = result["failed_subtasks"]
            return out
        return progress

    def stream_status(self, sid: str, job_id: str, tick_s: Optional[float] = None):
        """Generator of progress snapshots until the job ends, with the
        freshly ingested curves interleaved as ``{"kind": "curve", ...}``
        events (the CurveStore's version is the cursor, so each curve
        streams once). The snapshot is read before the curve drain: a
        terminal status means aggregation finished, so every curve is
        already behind the cursor and flushes before the last snapshot."""
        tick = tick_s if tick_s is not None else self.config.service.sse_tick_s
        since = 0
        while True:
            progress = self.store.job_progress(sid, job_id)
            fresh, since = self.curves.updates(job_id, since)
            for entry in fresh:
                yield {"kind": "curve", "job_id": job_id, **entry}
            yield progress
            if progress["job_status"] in TERMINAL_STATUSES:
                return
            time.sleep(tick)

    def job_metrics(self, sid: str, job_id: str) -> List[Dict[str, Any]]:
        """Per-subtask results array."""
        self._require_session(sid)
        return self.store.subtask_results(sid, job_id)

    def wait_for_completion(self, sid: str, job_id: str,
                            timeout_s: Optional[float] = None) -> Dict[str, Any]:
        timeout = timeout_s or self.config.service.client_timeout_s
        if not self.store.wait_job(sid, job_id, timeout):
            raise TimeoutError(f"Job {job_id} did not complete in time")
        return self.store.job_progress(sid, job_id)

    def best_model_path(self, sid: str, job_id: str) -> Optional[str]:
        """Path of the job's winner artifact: refitted on the device on the
        first call (runtime/executor.py::fit_artifact), the cached path
        after. None where the job has no winner spec (no completed trial,
        or a job read back from the journal)."""
        self._require_session(sid)
        with self._artifact_lock:
            path = self._artifact_paths.get((sid, job_id))
            if path is not None:
                return path
            st = self._artifact_specs.get((sid, job_id))
        if st is None:
            return None
        artifact = self.executor.fit_artifact(st)
        path = save_artifact(st["subtask_id"], artifact, self.config.storage.models_dir)
        with self._artifact_lock:
            self._artifact_paths[(sid, job_id)] = path
        return path

    # ------------- cost, critical path, explain -------------

    def job_cost(self, job_id: str) -> Optional[Dict[str, Any]]:
        """A job's device cost report: device-seconds, model FLOPs, the HBM
        high-water and MFU against the card's peak, summed from the
        ``batch_cost`` records the executors stamp on each batch's first
        result. None for an unknown job; a known job with no records
        (``CS230_OBS=0``) reports zeros and no groups. MFU is None on the
        CPU and whenever a group lacks a complete model-FLOP sum. The JAX
        report's schema (docs/OBSERVABILITY.md "Job cost report")."""
        sid = self.store.session_of(job_id)
        if sid is None:
            return None
        from ..utils.flops import device_peak_flops

        progress = self.store.job_progress(sid, job_id)
        groups: List[Dict[str, Any]] = []
        device_seconds = capacity_device_seconds = 0.0
        model_flops = xla_flops = bytes_accessed = 0.0
        hbm_peak = None
        priced = True  # every group carries a complete model-FLOP figure
        for r in self.store.subtask_results(sid, job_id):
            cost = (r or {}).get("batch_cost")
            if not cost:
                continue
            groups.append(dict(cost))
            secs = float(cost.get("device_seconds") or 0.0)
            device_seconds += secs
            capacity_device_seconds += secs * max(int(cost.get("n_devices") or 1), 1)
            if cost.get("model_flops") is not None and cost.get("flops_coverage") == 1.0:
                model_flops += float(cost["model_flops"])
            else:
                priced = False
            if cost.get("xla_flops") is not None:
                xla_flops += float(cost["xla_flops"])
            if cost.get("bytes_accessed") is not None:
                bytes_accessed += float(cost["bytes_accessed"])
            if cost.get("hbm_peak_bytes") is not None:
                hbm_peak = max(hbm_peak or 0, int(cost["hbm_peak_bytes"]))
        peak = device_peak_flops()
        mfu = None
        if peak and capacity_device_seconds > 0 and model_flops > 0 and priced:
            mfu = model_flops / (capacity_device_seconds * peak)
        return {
            "job_id": job_id,
            "session_id": sid,
            "job_status": progress.get("job_status"),
            "n_groups": len(groups),
            "device_seconds": device_seconds,
            "model_flops": model_flops if groups and priced else None,
            "xla_flops": xla_flops if xla_flops > 0 else None,
            "bytes_accessed": bytes_accessed if bytes_accessed > 0 else None,
            "hbm_peak_bytes": hbm_peak,
            "mfu": mfu,
            "device_peak_flops": peak,
            "groups": groups,
        }

    def critical_path(self, job_id: str) -> Optional[Dict[str, Any]]:
        """The job's wall decomposed into critical-path segments that sum
        to it exactly (obs/critpath.py; gaps are ``untraced``), from its
        spans and flight-recorder timelines. None when no trace is bound
        to the job (the ``GET /critical_path`` 404)."""
        from ..obs.critpath import critical_path as _critical_path

        tid = TRACER.trace_for_job(job_id)
        if tid is None:
            return None
        timelines = {stid: RECORDER.timeline(job_id, stid) or []
                     for stid in RECORDER.job_subtasks(job_id)}
        # the store's wall (created_at -> completion_time) beside the spans'
        job_wall = None
        sid = self.store.session_of(job_id)
        if sid is not None:
            try:
                job = self.store.get_job(sid, job_id)
                if job.get("completion_time") and job.get("created_at"):
                    job_wall = float(job["completion_time"]) - float(job["created_at"])
            except KeyError:
                pass
        return _critical_path(job_id, trace_id=tid, spans=TRACER.spans_for(tid),
                              timelines=timelines, job_wall_s=job_wall)

    def explain(self, job_id: str, subtask_id: str) -> Dict[str, Any]:
        """One subtask's flight-recorder timeline, every lifecycle decision
        in order. KeyError when the recorder never saw the pair (unknown
        ids, ``CS230_OBS=0``, or evicted): the ``GET /explain`` 404."""
        timeline = RECORDER.timeline(job_id, subtask_id)
        if timeline is None:
            raise KeyError(f"no recorded events for subtask {subtask_id!r} of job {job_id!r}")
        return {"job_id": job_id, "subtask_id": subtask_id, "n_events": len(timeline),
                "events": timeline}

    def _require_session(self, sid: str) -> None:
        if not self.store.has_session(sid):
            raise KeyError(f"Invalid session id: {sid}")
