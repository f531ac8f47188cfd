"""Adaptive search: ASHA / Hyperband rung controller (docs/SEARCH.md).

A copy of the JAX package's ``runtime/search.py``. It is framework-free;
the one change is that ``plan_trials`` draws its configurations through
``utils/sklearn_compat.py`` (draw-for-draw copies of scikit-learn's
``ParameterGrid`` / ``ParameterSampler``), so it runs where scikit-learn
is not installed.

The exhaustive Grid/Randomized fan-out runs every trial to its full budget
— at fleet scale most of those device-seconds are spent on trials that were
visibly doomed after a fraction of the budget. This module adds
asynchronous successive halving (ASHA, Li et al. 2020) and Hyperband
(Li et al. 2018) as first-class job types on top of the primitives the
runtime already owns:

- a trial's **resource** is its iteration budget (solver iterations for
  LogReg/MLP/SVM, boosting rounds / tree count for the ensembles), carried
  in the subtask's parameters, so a rung dispatch rides the vmapped trial
  engine unchanged;
- each **rung** is one dispatch of the trial at that rung's resource; the
  completion result (and the executor's per-batch metrics message) carries
  the intermediate validation score at the rung boundary;
- **promotion is asynchronous**: a trial promotes the moment it is in the
  top 1/eta of its rung's *reported* peers — no rung barrier. A promotion
  re-enqueues the trial as a fresh attempt with the eta-times-larger
  budget (optionally warm-started from its own lower-rung weights via the
  artifact plumbing, see ``warm_from`` below);
- **pruning is terminal but non-failure**: a trial that can never be
  promoted (its rank among reported peers already exceeds the rung's
  promotion quota, or the rung closed without promoting it) finalizes as
  the new ``pruned`` subtask status. Prune decisions for in-flight
  attempts ride the cooperative-cancel path: the coordinator synthesizes
  the terminal ``pruned`` result immediately (so liveness never depends on
  the worker) AND marks the attempt cancelled — the agent's next poll
  response carries the cancel list and the executor stops the trial at the
  next batch boundary instead of burning the rest of its budget. A dead or
  ignoring worker is already handled by the lease reclaim: the requeued
  copy is dropped by the ledger's ``is_done`` check.

The controller is **deterministic**: feeding the same reports in the same
order reproduces the same promotions/prunes, which is how a SIGKILLed
coordinator resumes rung state from the journal's replayed rung history
without double-promoting (``SearchJobDriver.resume``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ..obs import counter_inc, record_event
from ..utils.logging import get_logger

logger = get_logger("tpuml.search")

#: model family -> the parameter that IS the trial's resource budget.
#: Families without an iterative budget (KNN, NaiveBayes, plain linear
#: solves) cannot be early-stopped meaningfully and are rejected at
#: expansion time with a clear error.
RESOURCE_PARAMS: Dict[str, str] = {
    "LogisticRegression": "max_iter",
    "MLPClassifier": "max_iter",
    "MLPRegressor": "max_iter",
    "SVC": "max_iter",
    "LinearSVC": "max_iter",
    "SGDClassifier": "max_iter",
    "GradientBoostingClassifier": "n_estimators",
    "GradientBoostingRegressor": "n_estimators",
    "RandomForestClassifier": "n_estimators",
    "RandomForestRegressor": "n_estimators",
    "ExtraTreesClassifier": "n_estimators",
    "ExtraTreesRegressor": "n_estimators",
}

#: fallback full budget per resource param when neither the asha config
#: nor the base estimator pins one
_DEFAULT_MAX_RESOURCE = {"max_iter": 100, "n_estimators": 100}


def resource_param_for(model_type: str) -> str:
    param = RESOURCE_PARAMS.get(model_type)
    if param is None:
        raise ValueError(
            f"adaptive search needs an iterative resource budget, which "
            f"{model_type!r} does not expose; supported families: "
            f"{sorted(RESOURCE_PARAMS)}"
        )
    return param


def asha_schedule(min_resource: int, max_resource: int, eta: int) -> List[int]:
    """Geometric rung ladder [r, r*eta, ...] ending exactly at
    ``max_resource``. ``min_resource >= max_resource`` degenerates to a
    single rung at the full budget (== exhaustive search, nothing pruned
    before the full budget is spent)."""
    min_resource = max(int(min_resource), 1)
    max_resource = max(int(max_resource), 1)
    if min_resource >= max_resource:
        return [max_resource]
    ladder = [min_resource]
    while ladder[-1] * eta < max_resource:
        ladder.append(ladder[-1] * eta)
    if len(ladder) > 1 and max_resource < ladder[-1] * math.sqrt(eta):
        # a final step smaller than sqrt(eta) buys almost no halving
        # power but costs a full extra dispatch round — fold it into the
        # last geometric rung instead (e.g. [10, 30, 90, 100] -> [10, 30, 100])
        ladder[-1] = max_resource
    else:
        ladder.append(max_resource)
    return ladder


def hyperband_brackets(
    max_resource: int,
    eta: int = 3,
    max_brackets: Optional[int] = None,
    n_trials: Optional[int] = None,
) -> List[Dict[str, int]]:
    """Standard Hyperband bracket allocation (Li et al. 2018, Alg. 1):
    ``s_max + 1`` brackets trading off exploration (many trials, tiny
    starting budget) against exploitation (few trials, full budget).
    ``max_brackets`` keeps only the most-exploratory N brackets;
    ``n_trials`` rescales the per-bracket trial counts so the total equals
    the caller's budget (floored at 1 per bracket)."""
    eta = max(int(eta), 2)
    max_resource = max(int(max_resource), 1)
    s_max = int(math.floor(math.log(max_resource) / math.log(eta)))
    budget = (s_max + 1) * max_resource
    out = []
    for s in range(s_max, -1, -1):
        n = int(math.ceil(budget / max_resource * (eta ** s) / (s + 1)))
        r = max(1, int(max_resource * (eta ** -s)))
        out.append({"bracket": s, "n_trials": n, "min_resource": r})
    if max_brackets is not None and max_brackets > 0:
        out = out[:max_brackets]
    if n_trials is not None and n_trials > 0:
        total = sum(b["n_trials"] for b in out)
        for b in out:
            b["n_trials"] = max(1, round(b["n_trials"] * n_trials / total))
    return out


@dataclasses.dataclass
class Rung:
    index: int
    resource: int
    #: theoretical max entrants (rung 0: the bracket's n; k>0: the rung
    #: below's promotion quota). The early-prune rank test uses it as the
    #: never-exceedable promotion bound — safe even when failures shrink
    #: the real entrant count below capacity.
    capacity: int
    entered: set = dataclasses.field(default_factory=set)
    #: trial -> score, in report (seq) order — the tie-break order
    reported: Dict[str, float] = dataclasses.field(default_factory=dict)
    promoted: set = dataclasses.field(default_factory=set)
    #: decided at this rung without promotion (pruned or failed)
    removed: set = dataclasses.field(default_factory=set)


class AshaController:
    """Per-bracket asynchronous successive-halving state machine.

    ``on_report`` is **idempotent** — a duplicate (trial, rung) report, a
    report for a decided trial, or a stale lower-rung report after a
    promotion all return no decisions — which is what makes the journal
    replay and the at-least-once result ingest safe to feed directly.
    """

    def __init__(
        self,
        trial_ids: Iterable[str],
        *,
        min_resource: int,
        max_resource: int,
        eta: int = 3,
        bracket: int = 0,
        stop_score: Optional[float] = None,
    ):
        self.eta = max(int(eta), 2)
        self.bracket = bracket
        self.stop_score = stop_score
        self.max_resource = max(int(max_resource), 1)
        resources = asha_schedule(min_resource, self.max_resource, self.eta)
        ids = list(trial_ids)
        self.rungs: List[Rung] = []
        cap = len(ids)
        for k, r in enumerate(resources):
            self.rungs.append(Rung(index=k, resource=r, capacity=max(cap, 1)))
            cap = max(1, cap // self.eta)
        self.rungs[0].entered = set(ids)
        #: trial -> terminal outcome ("completed" | "pruned" | "failed")
        self.decided: Dict[str, str] = {}
        #: trial -> highest rung index entered
        self.trial_rung: Dict[str, int] = {tid: 0 for tid in ids}
        self.stopped = False

    # ---------------- rung math ----------------

    @property
    def top(self) -> int:
        return len(self.rungs) - 1

    def _max_promotions(self, k: int) -> int:
        """Hard bound on promotions out of rung k: the rung above's
        capacity. A reported trial ranked below it can never promote."""
        return 0 if k >= self.top else self.rungs[k + 1].capacity

    def _ranked(self, rung: Rung) -> List[str]:
        """Reported trials by score desc; ties resolve first-reported-first
        (dict insertion order), so replaying the same report order
        reproduces the same ranking."""
        order = {tid: i for i, tid in enumerate(rung.reported)}
        return sorted(
            rung.reported,
            key=lambda tid: (-rung.reported[tid], order[tid]),
        )

    def _closed(self, k: int) -> bool:
        """True when no further trial can ever ENTER rung k."""
        if k == 0:
            return True
        below = self.rungs[k - 1]
        return below.entered <= (below.promoted | below.removed)

    # ---------------- reports ----------------

    def on_report(
        self, trial_id: str, rung_idx: int, score: Optional[float]
    ) -> List[Dict[str, Any]]:
        """Feed one rung-boundary score; returns the decisions it caused —
        possibly about OTHER trials (a report can fill a quota, unlock a
        peer's promotion, or doom paused peers)."""
        if self.stopped or trial_id in self.decided:
            return []
        if rung_idx != self.trial_rung.get(trial_id):
            return []  # stale (superseded rung) or foreign report
        if rung_idx < 0 or rung_idx > self.top:
            return []
        rung = self.rungs[rung_idx]
        if trial_id in rung.reported or trial_id not in rung.entered:
            return []  # duplicate delivery / never scheduled here
        if not isinstance(score, (int, float)) or score != score:
            return self.on_trial_failed(trial_id)
        rung.reported[trial_id] = float(score)
        decisions: List[Dict[str, Any]] = []
        if self.stop_score is not None and score >= self.stop_score:
            return self._stop(trial_id, rung_idx, score)
        if rung_idx == self.top:
            self.decided[trial_id] = "completed"
            decisions.append(
                self._decision("complete", trial_id, rung_idx, score=score)
            )
        self._sweep(rung_idx, decisions)
        return decisions

    def on_trial_failed(self, trial_id: str) -> List[Dict[str, Any]]:
        """A rung execution failed terminally (quarantine): the trial
        leaves the ladder; its rung may now close for the survivors."""
        if trial_id in self.decided:
            return []
        self.decided[trial_id] = "failed"
        k = self.trial_rung.get(trial_id, 0)
        rung = self.rungs[k]
        rung.removed.add(trial_id)
        rung.reported.pop(trial_id, None)
        decisions: List[Dict[str, Any]] = []
        self._sweep(k, decisions)
        return decisions

    def _stop(self, trial_id, rung_idx, score) -> List[Dict[str, Any]]:
        """``stop_score`` reached: the winner completes where it stands and
        every other undecided trial is pruned (in-flight attempts are
        cancelled cooperatively by the driver)."""
        self.stopped = True
        self.decided[trial_id] = "completed"
        decisions = [
            self._decision(
                "complete", trial_id, rung_idx, score=score, reason="stop_score"
            )
        ]
        for tid in list(self.trial_rung):
            if tid in self.decided:
                continue
            self.decided[tid] = "pruned"
            k = self.trial_rung[tid]
            self.rungs[k].removed.add(tid)
            decisions.append(
                self._decision(
                    "prune", tid, k,
                    score=self.rungs[k].reported.get(tid),
                    reason="stop_score",
                )
            )
        return decisions

    # ---------------- promotion / prune sweep ----------------

    def _sweep(self, start: int, decisions: List[Dict[str, Any]]) -> None:
        """Re-evaluate rungs ``start``..top: async promotions up to
        floor(reported/eta), terminal prunes for trials that can never be
        promoted, and closure resolution (a fully-reported closed rung
        promotes at least its best survivor and prunes the rest). Closure
        cascades upward — resolving rung k can close rung k+1."""
        for k in range(start, self.top):
            rung = self.rungs[k]
            max_prom = self._max_promotions(k)
            # async promotion: top-1/eta of *reported* peers, no barrier
            quota = min(len(rung.reported) // self.eta, max_prom)
            closed = self._closed(k)
            fully_reported = closed and not (
                rung.entered - rung.removed - set(rung.reported)
            )
            if fully_reported and rung.reported:
                # rung closed with every survivor reported: promote at
                # least one so the ladder always delivers a trial to the
                # full budget, even when floor(n/eta) is 0 (max_prom is
                # >= 1 for every non-top rung by capacity construction)
                quota = min(max(quota, 1), max_prom)
            ranked = self._ranked(rung)
            active = [t for t in ranked if t not in self.decided]
            for tid in active:
                if len(rung.promoted) >= quota:
                    break
                if tid in rung.promoted:
                    continue
                self._promote(tid, k, decisions)
            # terminal prune: rank among reported only ever worsens and
            # max_prom is a hard bound — outside it means never promotable
            for pos, tid in enumerate(ranked):
                if tid in self.decided or tid in rung.promoted:
                    continue
                doomed = pos >= max_prom
                if doomed or (
                    fully_reported and len(rung.promoted) >= quota
                ):
                    self.decided[tid] = "pruned"
                    rung.removed.add(tid)
                    decisions.append(
                        self._decision(
                            "prune", tid, k, score=rung.reported[tid],
                            reason="outranked" if doomed else "rung_closed",
                        )
                    )
        # top rung has no promotions; nothing to sweep there

    def _promote(self, tid: str, k: int, decisions: List[Dict[str, Any]]) -> None:
        rung = self.rungs[k]
        nxt = self.rungs[k + 1]
        rung.promoted.add(tid)
        nxt.entered.add(tid)
        self.trial_rung[tid] = k + 1
        decisions.append(
            self._decision(
                "promote", tid, k, score=rung.reported.get(tid),
                to_rung=k + 1, to_resource=nxt.resource,
            )
        )

    def _decision(self, action, tid, rung_idx, score=None, **extra):
        rung = self.rungs[rung_idx]
        return {
            "action": action,
            "trial_id": tid,
            "bracket": self.bracket,
            "rung": rung_idx,
            "resource": rung.resource,
            "score": score,
            "peers": len(rung.reported),
            **extra,
        }

    # ---------------- queries ----------------

    def force_decide(self, trial_id: str, outcome: str) -> List[Dict[str, Any]]:
        """Adopt a terminal outcome the journal already committed (e.g. a
        ``pruned`` result for a cancelled attempt, whose triggering report
        never had a score to replay). First-wins: a trial the replay
        already decided is untouched. Pruned/failed trials leave their
        rung so closure math proceeds for the survivors."""
        if trial_id in self.decided or trial_id not in self.trial_rung:
            return []
        self.decided[trial_id] = outcome
        k = self.trial_rung[trial_id]
        if outcome in ("pruned", "failed", "diverged"):
            self.rungs[k].removed.add(trial_id)
            self.rungs[k].reported.pop(trial_id, None)
        decisions: List[Dict[str, Any]] = []
        self._sweep(k, decisions)
        return decisions

    def is_complete(self) -> bool:
        return all(tid in self.decided for tid in self.trial_rung)

    def pending_rungs(self) -> Dict[str, Tuple[int, int]]:
        """trial -> (rung index, resource) for every undecided trial whose
        current rung has no report yet — exactly the dispatches a resumed
        coordinator must (re-)issue."""
        out = {}
        for tid, k in self.trial_rung.items():
            if tid in self.decided:
                continue
            if tid not in self.rungs[k].reported:
                out[tid] = (k, self.rungs[k].resource)
        return out

    def summary(self) -> Dict[str, Any]:
        return {
            "bracket": self.bracket,
            "eta": self.eta,
            "max_resource": self.max_resource,
            "stopped": self.stopped,
            "rungs": [
                {
                    "rung": r.index,
                    "resource": r.resource,
                    "entered": len(r.entered),
                    "reported": len(r.reported),
                    "promoted": len(r.promoted),
                    "pruned": len(
                        [t for t in r.removed if self.decided.get(t) == "pruned"]
                    ),
                }
                for r in self.rungs
            ],
            "completed": sum(
                1 for v in self.decided.values() if v == "completed"
            ),
            "pruned": sum(1 for v in self.decided.values() if v == "pruned"),
            "failed": sum(1 for v in self.decided.values() if v == "failed"),
            # numerical-health watchdog terminals (docs/OBSERVABILITY.md
            # "Trial telemetry plane") — non-failure, like pruned
            "diverged": sum(
                1 for v in self.decided.values() if v == "diverged"
            ),
            "n_trials": len(self.trial_rung),
        }


class MultiBracketController:
    """Hyperband: independent ASHA brackets, one controller each; the
    trial's spec carries its bracket id. Complete when every bracket is."""

    def __init__(self, brackets: Dict[int, AshaController],
                 trial_bracket: Dict[str, int]):
        self.brackets = brackets
        self.trial_bracket = trial_bracket

    def _ctrl(self, trial_id: str) -> Optional[AshaController]:
        b = self.trial_bracket.get(trial_id)
        return self.brackets.get(b) if b is not None else None

    def on_report(self, trial_id, rung_idx, score):
        ctrl = self._ctrl(trial_id)
        return ctrl.on_report(trial_id, rung_idx, score) if ctrl else []

    def on_trial_failed(self, trial_id):
        ctrl = self._ctrl(trial_id)
        return ctrl.on_trial_failed(trial_id) if ctrl else []

    def force_decide(self, trial_id, outcome):
        ctrl = self._ctrl(trial_id)
        return ctrl.force_decide(trial_id, outcome) if ctrl else []

    def is_complete(self):
        return all(c.is_complete() for c in self.brackets.values())

    def pending_rungs(self):
        out = {}
        for c in self.brackets.values():
            out.update(c.pending_rungs())
        return out

    @property
    def decided(self):
        merged: Dict[str, str] = {}
        for c in self.brackets.values():
            merged.update(c.decided)
        return merged

    @property
    def trial_rung(self):
        merged: Dict[str, int] = {}
        for c in self.brackets.values():
            merged.update(c.trial_rung)
        return merged

    def rung_resource(self, trial_id: str, rung_idx: int) -> int:
        ctrl = self._ctrl(trial_id)
        return ctrl.rungs[rung_idx].resource if ctrl else 0

    def summary(self):
        per = [c.summary() for _, c in sorted(self.brackets.items())]
        return {
            "brackets": per,
            "completed": sum(s["completed"] for s in per),
            "pruned": sum(s["pruned"] for s in per),
            "failed": sum(s["failed"] for s in per),
            "diverged": sum(s.get("diverged", 0) for s in per),
            "n_trials": sum(s["n_trials"] for s in per),
        }


# ---------------- trial planning (subtask expansion) ----------------


def plan_trials(model_details: Dict[str, Any]) -> List[Tuple[Dict[str, Any], Dict[str, Any]]]:
    """Expand an asha/hyperband job into (param combo, asha block) pairs —
    the ``create_subtasks`` input. The asha block is the spec's rung-state
    stamp: {rung, resource, min_resource, max_resource, eta, bracket,
    resource_param, stop_score?}. The resource param is controller-owned:
    a sampled value for it is dropped from the combo."""
    from ..utils.sklearn_compat import parameter_grid, parameter_sampler

    model_type = model_details["model_type"]
    search_type = model_details.get("search_type")
    cfg = dict(model_details.get("asha") or {})
    resource_param = cfg.get("resource_param") or resource_param_for(model_type)
    base = dict(model_details.get("base_estimator_params") or {})
    eta = max(int(cfg.get("eta", 3)), 2)
    max_resource = int(
        cfg.get("max_resource")
        or base.get(resource_param)
        or _DEFAULT_MAX_RESOURCE.get(resource_param, 100)
    )
    min_resource = int(cfg.get("min_resource") or max(1, max_resource // eta ** 2))
    stop_score = cfg.get("stop_score")

    def _draw(n: Optional[int]) -> List[Dict[str, Any]]:
        """``n`` trial configurations; None = the caller set no n_iter —
        sample the distribution default (16) or run the FULL grid (a
        param_grid must never be silently truncated: exhaustive
        GridSearchCV runs every combo, and so does asha over a grid)."""
        dists = model_details.get("param_distributions")
        if dists:
            return parameter_sampler(
                dists, int(n or 16), model_details.get("random_state"),
            )
        grid = model_details.get("param_grid") or {}
        combos = parameter_grid(grid) if grid else [{}]
        if n is not None and 0 < n < len(combos):
            return combos[:n]
        return combos

    def _block(rung0_resource: int, bracket: int) -> Dict[str, Any]:
        block = {
            "rung": 0,
            "resource": int(rung0_resource),
            "min_resource": int(rung0_resource),
            "max_resource": max_resource,
            "eta": eta,
            "bracket": bracket,
            "resource_param": resource_param,
        }
        if stop_score is not None:
            block["stop_score"] = float(stop_score)
        return block

    out: List[Tuple[Dict[str, Any], Dict[str, Any]]] = []
    if search_type == "hyperband":
        brackets = hyperband_brackets(
            max_resource, eta,
            max_brackets=cfg.get("max_brackets"),
            n_trials=model_details.get("n_iter"),
        )
        total = sum(b["n_trials"] for b in brackets)
        combos = _draw(total)
        i = 0
        for b in brackets:
            for _ in range(b["n_trials"]):
                combo = dict(combos[i % len(combos)])
                i += 1
                combo.pop(resource_param, None)
                out.append((combo, _block(b["min_resource"], b["bracket"])))
    else:  # asha: one bracket
        n_iter = model_details.get("n_iter")
        for combo in _draw(int(n_iter) if n_iter else None):
            combo = dict(combo)
            combo.pop(resource_param, None)
            out.append((combo, _block(min_resource, 0)))
    return out


def build_controller(specs: List[Dict[str, Any]]) -> MultiBracketController:
    """Rebuild the bracket controllers from the subtask specs' asha blocks
    (works for fresh jobs and journal-replayed ones alike — the blocks are
    journaled with the specs)."""
    by_bracket: Dict[int, List[Dict[str, Any]]] = {}
    for st in specs:
        a = st.get("asha") or {}
        by_bracket.setdefault(int(a.get("bracket", 0)), []).append(st)
    brackets: Dict[int, AshaController] = {}
    trial_bracket: Dict[str, int] = {}
    for b, sts in by_bracket.items():
        a0 = sts[0].get("asha") or {}
        brackets[b] = AshaController(
            [st["subtask_id"] for st in sts],
            min_resource=int(a0.get("min_resource", 1)),
            max_resource=int(a0.get("max_resource", 100)),
            eta=int(a0.get("eta", 3)),
            bracket=b,
            stop_score=a0.get("stop_score"),
        )
        for st in sts:
            trial_bracket[st["subtask_id"]] = b
    return MultiBracketController(brackets, trial_bracket)


# ---------------- coordinator-facing driver ----------------


@dataclasses.dataclass
class Step:
    """The dispatch-side effect of one ingested report: terminal results
    to finalize, intermediate (promoted) results to store, fresh rung
    dispatches to enqueue, and in-flight attempts to cancel."""

    finished: List[Tuple[str, str, Dict[str, Any]]] = dataclasses.field(
        default_factory=list
    )
    promoted: List[Tuple[str, Dict[str, Any]]] = dataclasses.field(
        default_factory=list
    )
    new_tasks: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    cancels: List[Dict[str, Any]] = dataclasses.field(default_factory=list)


class SearchJobDriver:
    """Bridges the rung controller to the coordinator's result loop.

    All ``handle_*`` entry points are idempotent: the controller dedups
    reports, ``_issued`` guards duplicate rung dispatches, and
    ``_finalized`` guards duplicate terminal emissions — so the same
    report may arrive via the metrics feed AND the result ingest (or be
    replayed from the journal) without double-promoting.
    """

    def __init__(self, specs: List[Dict[str, Any]]):
        self.specs = {st["subtask_id"]: st for st in specs}
        self.controller = build_controller(specs)
        self.job_id = specs[0].get("job_id") if specs else None
        self._seq = 0
        #: trial -> highest rung index a dispatch was issued for
        self._issued: Dict[str, int] = {tid: 0 for tid in self.specs}
        self._finalized: set = set()
        #: trial -> sum of resources of completed rung dispatches
        self._spent: Dict[str, int] = {}
        #: (trial, rung) pairs already absorbed into the spent accounting
        self._counted: set = set()
        #: trial -> last REAL result seen (any rung) — synthesized
        #: terminals merge over it so pruned/paused trials keep their
        #: measured metrics instead of a bare stub
        self._last_result: Dict[str, Dict[str, Any]] = {}
        #: trial -> (training_time_s, resource) of the last completed rung
        self._last_time: Dict[str, Tuple[float, int]] = {}

    # ---------------- dispatch specs ----------------

    def _stamp(self, spec: Dict[str, Any], rung: int, resource: int,
               warm_from: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        task = dict(spec)
        a = dict(task.get("asha") or {})
        a.update(rung=rung, resource=int(resource))
        if warm_from is not None:
            a["warm_from"] = warm_from
        elif "warm_from" in a:
            a.pop("warm_from")
        task["asha"] = a
        params = dict(task.get("parameters") or {})
        params[a["resource_param"]] = int(resource)
        task["parameters"] = params
        tp = dict(task.get("train_params") or {})
        tp["rung"] = rung
        tp["resource"] = int(resource)
        task["train_params"] = tp
        self.specs[task["subtask_id"]] = task
        return task

    def pending_tasks(self) -> List[Dict[str, Any]]:
        """Rung dispatches currently owed: for a fresh job, every trial's
        rung 0; after ``resume``, exactly the unreported current rungs."""
        tasks = []
        for tid, (rung, resource) in sorted(
            self.controller.pending_rungs().items()
        ):
            self._issued[tid] = rung
            warm = self.specs[tid].get("asha", {}).get("warm_from")
            tasks.append(self._stamp(self.specs[tid], rung, resource,
                                     warm_from=warm))
        return tasks

    def done(self) -> bool:
        return self.controller.is_complete()

    def summary(self) -> Dict[str, Any]:
        return self.controller.summary()

    # ---------------- resume (journal replay) ----------------

    def resume(self, job_record: Dict[str, Any]) -> None:
        """Rebuild rung state from the journaled rung history. Reports are
        re-fed in their original global ``seq`` order; the controller's
        determinism reproduces every promotion/prune, so nothing is
        promoted twice and ``pending_tasks`` yields only the dispatches
        still owed."""
        entries = []
        for stid, sub in (job_record.get("subtasks") or {}).items():
            for h in sub.get("rung_history") or []:
                # only REAL execution reports re-feed the controller;
                # synthesized terminal entries carry no ``report`` flag
                # (their outcome is adopted via force_decide below)
                if h.get("report") or h.get("failed"):
                    entries.append((h.get("seq", 0), stid, h))
        replayed = 0
        for seq, stid, h in sorted(entries, key=lambda e: e[0]):
            self._seq = max(self._seq, int(seq))
            if h.get("failed"):
                self.controller.on_trial_failed(stid)
                continue
            rung = int(h.get("rung", 0))
            self.controller.on_report(stid, rung, h.get("score"))
            if (stid, rung) not in self._counted:
                self._counted.add((stid, rung))
                self._spent[stid] = self._spent.get(stid, 0) + int(
                    h.get("resource", 0)
                )
            replayed += 1
        # terminal results already journaled must stay final even if the
        # controller would re-derive them differently (first-wins). The
        # force covers trials whose terminal state had no replayable
        # report — e.g. a ``pruned`` write for a cancelled attempt.
        from .store import SUBTASK_TERMINAL_STATUSES

        for stid, sub in (job_record.get("subtasks") or {}).items():
            status = sub.get("status")
            if status in SUBTASK_TERMINAL_STATUSES:
                self._finalized.add(stid)
                self.controller.force_decide(stid, status)
        if replayed:
            logger.info(
                "Search job %s resumed: %d rung reports replayed, "
                "%d trials decided, %d dispatches pending",
                self.job_id, replayed, len(self.controller.decided),
                len(self.controller.pending_rungs()),
            )
            record_event(
                "rung.resume", job_id=self.job_id, replayed=replayed,
                decided=len(self.controller.decided),
                pending=len(self.controller.pending_rungs()),
            )

    def resume_step(self) -> Step:
        """Terminal states the replayed controller derived whose store
        writes were lost in the crash (decided but no journaled terminal
        result): synthesize them now so the resumed job can finalize
        without waiting on reports that will never come."""
        step = Step()
        for tid, outcome in sorted(self.controller.decided.items()):
            if tid in self._finalized:
                continue
            self._finalized.add(tid)
            ctrl = self.controller._ctrl(tid)
            k = self.controller.trial_rung.get(tid, 0)
            score = None
            if ctrl is not None:
                score = ctrl.rungs[min(k, ctrl.top)].reported.get(tid)
            res = self._synth_result(
                tid, outcome,
                {"reason": "replay", "rung": k, "score": score},
            )
            step.finished.append((tid, outcome, res))
        return step

    # ---------------- report ingest ----------------

    def handle_result(self, stid: str, result: Dict[str, Any]) -> Step:
        """A completed rung dispatch reported its validation score."""
        a = dict(result.get("asha") or self.specs[stid].get("asha") or {})
        rung = int(a.get("rung", self._issued.get(stid, 0)))
        score = result.get("mean_cv_score")
        if not isinstance(score, (int, float)) or score != score:
            # a completed result with no usable score cannot climb the
            # ladder — treat it like a terminal execution failure
            return self.handle_quarantine(stid, result)
        score = self._curve_adjusted_score(result, float(score))
        tt = result.get("training_time")
        resource = int(a.get("resource", 0))
        self._last_result[stid] = result
        ctrl = self.controller._ctrl(stid)

        def _in_reported() -> bool:
            return (
                ctrl is not None
                and 0 <= rung <= ctrl.top
                and stid in ctrl.rungs[rung].reported
            )

        before = _in_reported()
        decisions = self.controller.on_report(stid, rung, score)
        absorbed = _in_reported() and not before
        if not absorbed:
            # duplicate delivery, a stale-rung zombie (pre-crash attempt),
            # or an already-decided trial: nothing to journal — writing it
            # would replay as a report the live controller never consumed
            return self._apply(decisions, reporting=None)
        self._counted.add((stid, rung))
        self._spent[stid] = self._spent.get(stid, 0) + resource
        if isinstance(tt, (int, float)) and resource > 0:
            self._last_time[stid] = (float(tt), resource)
        self._seq += 1
        # ``report: True`` marks a REAL execution report — exactly the
        # entries ``resume`` re-feeds (synthesized terminals carry none)
        a.update(score=score, seq=self._seq, report=True)
        result["asha"] = a
        return self._apply(decisions, reporting=(stid, result))

    def handle_metrics(self, msg: Dict[str, Any]) -> Step:
        """Rung-boundary score off a per-batch metrics message — the early
        feed (``Coordinator.on_metrics``). Deliberately restricted to the
        one decision that cannot wait for the result ingest: a
        ``stop_score`` hit, whose cancels must reach still-running batches
        NOW. Every other rung decision rides the result ingest so the
        journaled report order (the replay order) is exactly the order the
        controller consumed — the determinism the no-double-promotion
        guarantee rests on."""
        stid = msg.get("subtask_id")
        score = msg.get("intermediate_score")
        if stid not in self.specs or score is None:
            return Step()
        ctrl = self.controller._ctrl(stid)
        if (
            ctrl is None
            or ctrl.stop_score is None
            or not isinstance(score, (int, float))
            or score < ctrl.stop_score
        ):
            return Step()
        decisions = self.controller.on_report(
            stid, int(msg.get("rung", 0)), score
        )
        return self._apply(decisions, reporting=None)

    def handle_pruned_result(self, stid: str, result: Dict[str, Any]) -> Step:
        """A worker posted the terminal ``pruned`` result for a cancelled
        attempt. Usually the coordinator already synthesized the terminal
        state (the cancel was advisory) — then this is a duplicate and
        yields nothing."""
        if stid in self._finalized or stid not in self.specs:
            return Step()
        # a cancel the coordinator never decided (e.g. a stale executor
        # cancel entry surviving a restart) — adopt the worker's terminal
        # state through force_decide so the trial also LEAVES its rung
        # (closure math for the surviving peers must keep moving)
        decisions = self.controller.force_decide(stid, "pruned")
        step = self._apply(decisions, reporting=None)
        if stid not in self._finalized:
            self._finalized.add(stid)
            step.finished.append((stid, "pruned", result))
        return step

    def _curve_adjusted_score(
        self, result: Dict[str, Any], score: float
    ) -> float:
        """Curve-aware rung decisions (docs/SEARCH.md), opt-in via
        ``CS230_ASHA_CURVE=1``: tilt the reported score by the learning
        curve's last-k slope so a still-improving trial outranks a
        plateaued peer with the same boundary score. The tilt is bounded
        (±5% of |score|) and ADDITIVE, so ranking stays stable and the
        adjusted value is what gets journaled — replay re-feeds the same
        number and reproduces the same promotions."""
        import os

        if os.environ.get("CS230_ASHA_CURVE") != "1":
            return score
        curve = result.get("curve")
        if not isinstance(curve, dict):
            return score
        from ..obs.curves import last_k_slope

        rows, sign = None, 1.0
        if isinstance(curve.get("loss"), list) and curve["loss"]:
            rows, sign = curve["loss"], -1.0  # falling loss = improving
        elif isinstance(curve.get("score"), list) and curve["score"]:
            rows, sign = curve["score"], 1.0
        if not rows:
            return score
        tilts = []
        for row in rows:
            slope = last_k_slope(row)
            if slope is None:
                continue
            finite = [v for v in row if isinstance(v, (int, float))]
            ref = max(abs(finite[-1]), 1e-12) if finite else 1.0
            tilts.append(sign * slope / ref)
        if not tilts:
            return score
        tilt = max(-0.05, min(0.05, sum(tilts) / len(tilts)))
        return score + abs(score) * tilt

    def handle_diverged(
        self,
        stid: str,
        curve: Dict[str, Any],
        result: Optional[Dict[str, Any]] = None,
    ) -> Step:
        """Numerical-health watchdog verdict (docs/OBSERVABILITY.md
        "Trial telemetry plane"): the trial's learning curve went
        non-finite, or its tail blew past ``curve_divergence_factor`` ×
        its early-trace median. The trial leaves the ladder under the
        NON-failure terminal ``diverged`` — never quarantine, numerics
        (a bad hyperparameter draw) killed it, not infrastructure — and
        never climbs to a higher rung, which is where the device-second
        savings come from. ``result`` is the delivering rung result when
        the curve rode a completed result (nothing left to cancel);
        None when it rode the early metrics feed, in which case the
        attempt is still burning budget and gets a cooperative cancel
        (PR-12 path: the executor drops it at the next batch boundary)."""
        if stid in self._finalized or stid not in self.specs:
            return Step()
        rung = int(self.controller.trial_rung.get(stid, 0))
        if result is not None:
            self._last_result[stid] = dict(result)
            a0 = dict(result.get("asha") or {})
            tt = result.get("training_time")
            resource = int(a0.get("resource", 0) or 0)
            if isinstance(tt, (int, float)) and resource > 0:
                self._last_time[stid] = (float(tt), resource)
                if (stid, rung) not in self._counted:
                    self._counted.add((stid, rung))
                    self._spent[stid] = self._spent.get(stid, 0) + resource
        decisions = self.controller.force_decide(stid, "diverged")
        step = self._apply(decisions, reporting=None)
        self._finalized.add(stid)
        counter_inc("tpuml_trials_diverged_total")
        saved = self._device_seconds_saved(stid)
        if saved is not None and saved > 0:
            counter_inc(
                "tpuml_device_seconds_saved_total", saved, reason="diverge"
            )
        record_event(
            "trial.diverge", job_id=self.job_id, subtask_id=stid,
            rung=rung, nonfinite=bool((curve or {}).get("nonfinite")),
            device_seconds_saved=round(saved, 6) if saved else None,
        )
        if result is None:
            spec = self.specs[stid]
            attempt = int(spec.get("attempt") or 0)
            counter_inc("tpuml_trials_cancelled_total")
            record_event(
                "trial.cancel", job_id=self.job_id, subtask_id=stid,
                attempt=attempt, rung=rung, reason="diverged",
            )
            step.cancels.append(
                {"subtask_id": stid, "attempt": attempt,
                 "job_id": self.job_id}
            )
        res = self._synth_result(
            stid, "diverged",
            {"rung": rung, "reason": "diverged", "score": None},
        )
        step.finished.append((stid, "diverged", res))
        return step

    def handle_quarantine(self, stid: str, result: Dict[str, Any]) -> Step:
        """The retry layer gave up on a rung execution: the trial leaves
        the ladder as failed; its rung may close for the survivors."""
        decisions = self.controller.on_trial_failed(stid)
        self._seq += 1
        a = dict(result.get("asha") or self.specs[stid].get("asha") or {})
        a.update(failed=True, seq=self._seq)
        result["asha"] = a
        step = self._apply(decisions, reporting=None)
        if stid not in self._finalized:
            self._finalized.add(stid)
            step.finished.append((stid, "failed", result))
        return step

    # ---------------- decision application ----------------

    def _apply(
        self,
        decisions: List[Dict[str, Any]],
        reporting: Optional[Tuple[str, Dict[str, Any]]] = None,
    ) -> Step:
        step = Step()
        rep_stid, rep_result = reporting if reporting else (None, None)
        rep_handled = False
        for d in decisions:
            tid = d["trial_id"]
            if d["action"] == "promote":
                self._on_promote(d, step)
                if tid == rep_stid:
                    rep_handled = True
                    step.promoted.append((tid, rep_result))
            elif d["action"] == "prune":
                self._on_prune(d, step, rep_result if tid == rep_stid else None)
                if tid == rep_stid:
                    rep_handled = True
            elif d["action"] == "complete":
                if tid in self._finalized:
                    continue
                self._finalized.add(tid)
                res = rep_result if tid == rep_stid else self._synth_result(
                    tid, "completed", d
                )
                if tid == rep_stid:
                    rep_handled = True
                step.finished.append((tid, "completed", res))
        if rep_stid is not None and not rep_handled:
            # reported but paused (awaiting async promotion): store the
            # intermediate score, no terminal transition
            if rep_stid not in self._finalized:
                step.promoted.append((rep_stid, rep_result))
        return step

    def _on_promote(self, d: Dict[str, Any], step: Step) -> None:
        tid = d["trial_id"]
        counter_inc("tpuml_trials_promoted_total")
        record_event(
            "rung.promote", job_id=self.job_id, subtask_id=tid,
            rung=d["rung"], to_rung=d["to_rung"], resource=d["resource"],
            to_resource=d["to_resource"], score=d.get("score"),
            peers=d.get("peers"), bracket=d.get("bracket"),
        )
        if self._issued.get(tid, -1) >= d["to_rung"]:
            return  # dispatch already out (resume / duplicate feed)
        self._issued[tid] = d["to_rung"]
        # warm-start handoff (docs/SEARCH.md "Warm start"): the promoted
        # dispatch points at its own lower-rung fit so executors that can
        # inject weights skip the already-paid iterations; the artifact
        # plumbing (runtime/artifacts.py) is the serialization format
        warm = {
            "subtask_id": tid,
            "rung": d["rung"],
            "resource": d["resource"],
        }
        step.new_tasks.append(
            self._stamp(self.specs[tid], d["to_rung"], d["to_resource"],
                        warm_from=warm)
        )

    def _on_prune(self, d: Dict[str, Any], step: Step,
                  rep_result: Optional[Dict[str, Any]]) -> None:
        tid = d["trial_id"]
        if tid in self._finalized:
            return
        self._finalized.add(tid)
        counter_inc("tpuml_trials_pruned_total")
        saved = self._device_seconds_saved(tid)
        if saved is not None and saved > 0:
            counter_inc(
                "tpuml_device_seconds_saved_total", saved, reason="prune"
            )
        record_event(
            "rung.prune", job_id=self.job_id, subtask_id=tid,
            rung=d["rung"], resource=d["resource"], score=d.get("score"),
            peers=d.get("peers"), bracket=d.get("bracket"),
            reason=d.get("reason"),
            device_seconds_saved=round(saved, 6) if saved else None,
        )
        if rep_result is not None:
            res = dict(rep_result)
            res["status"] = "pruned"
            res["pruned"] = True
            res["prune_reason"] = d.get("reason")
        else:
            res = self._synth_result(tid, "pruned", d)
            # the trial may have an attempt in flight (stop_score, or a
            # straggler retry): cancel it cooperatively so the worker
            # stops at the next batch boundary instead of finishing the
            # doomed budget
            if self._issued.get(tid, 0) == self.controller.trial_rung.get(
                tid, 0
            ) and tid not in self._reported_current(tid):
                spec = self.specs[tid]
                attempt = int(spec.get("attempt") or 0)
                counter_inc("tpuml_trials_cancelled_total")
                record_event(
                    "trial.cancel", job_id=self.job_id, subtask_id=tid,
                    attempt=attempt, rung=d["rung"], reason=d.get("reason"),
                )
                step.cancels.append(
                    {"subtask_id": tid, "attempt": attempt,
                     "job_id": self.job_id}
                )
        step.finished.append((tid, "pruned", res))

    def _reported_current(self, tid: str) -> set:
        ctrl = self.controller._ctrl(tid)
        if ctrl is None:
            return set()
        k = ctrl.trial_rung.get(tid, 0)
        return set(ctrl.rungs[min(k, ctrl.top)].reported)

    def _device_seconds_saved(self, tid: str) -> Optional[float]:
        """Estimated device-seconds NOT spent because this trial stops
        short of the full budget, priced from its own measured per-unit
        cost (hardware-grounded, not a predictor guess)."""
        last = self._last_time.get(tid)
        a = self.specs[tid].get("asha") or {}
        max_r = int(a.get("max_resource", 0))
        spent = self._spent.get(tid, 0)
        if last is None or max_r <= spent:
            return None
        tt, r = last
        return (tt / max(r, 1)) * (max_r - spent)

    def _synth_result(self, tid: str, status: str, d: Dict[str, Any]) -> Dict[str, Any]:
        spec = self.specs[tid]
        self._seq += 1
        base = dict(self._last_result.get(tid) or {})
        score = d.get("score")
        if score is None:
            score = base.get("mean_cv_score")
        base.update({
            "subtask_id": tid,
            "job_id": spec.get("job_id"),
            "model_type": spec.get("model_type"),
            "parameters": spec.get("parameters"),
            "search_params": spec.get("search_params"),
            "status": status,
            "mean_cv_score": score,
            "attempt": int(spec.get("attempt") or 0),
            "asha": {
                **(spec.get("asha") or {}),
                "rung": d.get("rung"),
                "score": score,
                "seq": self._seq,
            },
        })
        if status == "pruned":
            base["pruned"] = True
            base["prune_reason"] = d.get("reason")
        elif status == "diverged":
            # watchdog terminal: flagged so the ranking/predictor paths
            # can skip it (its last measured score is numerically suspect)
            base["diverged"] = True
            base["diverge_reason"] = d.get("reason", "diverged")
        return base
