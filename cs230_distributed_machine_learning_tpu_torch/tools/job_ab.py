"""Time whole search jobs of several checkouts of the port on one card, in turns.

    python3 cs230_distributed_machine_learning_tpu_torch/tools/job_ab.py \\
        --trees OLD NEW NEW OLD [--history 8] [--profile] [--out FILE]
    python3 cs230_distributed_machine_learning_tpu_torch/tools/job_ab.py \
        --stream --trees . [--out FILE]

Each entry of ``--trees`` is the root of a checkout (for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists, and ``.``). For each entry in order, a fresh process
imports that checkout's package and runs, through ``MLTaskManager()`` on
the card, the jobs of ``chip_smoke.py`` where the host's work a result
shows:

- ``main_10``: bench.py's 1000-trial LogReg search on covertype at
  max_iter 10 (the packed path, B2);
- ``scored_main``: 256 trials at max_iter 200 scored by neg_log_loss (the
  generic nesterov driver, B3 at 1,536 lanes);
- ``knn_main``: the 4-trial KNN grid on the 200,000-row table (B6, 49
  query chunks a bucket, the score-vs-chunk curve's extra evaluations).

In each process: the datasets are staged (shared by every process under
``.smoke_storage/job_ab`` beside this checkout; each process journals
under a directory of its own), each job runs once to warm up, then
``--history`` more runs of ``main_10`` grow the heap as a smoke's earlier
jobs do (the job store keeps every result), then each job runs four times
in turns with ``CS230_CURVES`` 0, auto, auto, 0. For every timed run:
the wall, the garbage collector's pauses during it by generation, and the
objects it tracked before it. With ``--profile``, one more run of each
job with curves on under cProfile of the job thread: the functions by
own time, and the package's functions by cumulative time. Also the
journal directory's cost of a line: an open, append and close against a
write to a handle kept open.

With ``--stream``, each process instead runs ``chip_smoke.py``'s two
streamed jobs on uncut covertype under a 20 MB stage budget (every pass
re-uploads every block): ``stream_logreg`` (bench.py's search at its
first 16 trials, max_iter 200) and ``stream_rf`` (8 trees of depth 8,
cv 3). Each runs once to warm up, then four times with
``CS230_STREAM_DOUBLE_BUFFER`` 1, 0, 0, 1: the wall, the consumer's
block waits, the upload seconds, the blocks and the block uploads of
every run.

Prints one JSON line per entry and, last, the card's name and power
limit. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
STORAGE = os.path.join(ROOT, ".smoke_storage", "job_ab")
JOBS = ("main_10", "scored_main", "knn_main")
TURNS = ("0", "auto", "auto", "0")
STREAM_JOBS = ("stream_logreg", "stream_rf")
STREAM_TURNS = ("1", "0", "0", "1")
STREAM_VALVES = {"CS230_STAGE_CACHE_MB": "20", "CS230_STREAM": "auto"}


def _search(n_iter, max_iter, cv=5):
    """bench.py's RandomizedSearchCV(LogisticRegression) as model_details."""
    from scipy.stats import loguniform

    return {"model_type": "LogisticRegression", "search_type": "RandomizedSearchCV",
            "base_estimator_params": {"max_iter": max_iter},
            "param_distributions": {"C": loguniform(1e-3, 1e2), "tol": [1e-4, 1e-3]},
            "n_iter": n_iter, "random_state": 0, "cv_params": {"cv": cv}}


def _job(name):
    if name == "stream_logreg":
        return _search(16, 200), "covertype", 16
    if name == "stream_rf":
        return ({"model_type": "RandomForestClassifier", "search_type": None,
                 "base_estimator_params": {"n_estimators": 8, "max_depth": 8,
                                           "random_state": 42},
                 "cv_params": {"cv": 3}}, "covertype", 1)
    if name == "main_10":
        return _search(1000, 10), "covertype", 1000
    if name == "scored_main":
        search = _search(256, 200)
        search["cv_params"] = {"cv": 5, "scoring": "neg_log_loss"}
        return search, "covertype", 256
    grid = {"n_neighbors": [5, 25], "weights": ["uniform", "distance"]}
    return ({"model_type": "KNeighborsClassifier", "search_type": "GridSearchCV",
             "base_estimator_params": {}, "param_grid": grid, "cv_params": {"cv": 5}},
            "synthetic_200000x54x7", 4)


def _journal_line_us(d: str, n: int = 2000) -> dict:
    """Microseconds a journal line costs in ``d``: open-append-close, and a
    write to a line-buffered handle kept open."""
    import time

    os.makedirs(d, exist_ok=True)
    line = json.dumps({"kind": "result", "job_id": "x" * 36, "data": {"score": 0.5}}) + "\n"
    path = os.path.join(d, "probe.jsonl")
    t0 = time.perf_counter()
    for _ in range(n):
        with open(path, "a") as f:
            f.write(line)
    reopen = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    with open(path, "a", buffering=1) as f:
        for _ in range(n):
            f.write(line)
    kept = (time.perf_counter() - t0) / n * 1e6
    os.remove(path)
    return {"open_append_close": reopen, "kept_handle": kept}


def _use_storage(run_dir: str) -> None:
    """Point the framework's storage at ``run_dir``, with the shared
    datasets linked in."""
    from cs230_distributed_machine_learning_tpu_torch.utils import config as cfg_mod

    os.makedirs(os.path.join(STORAGE, "datasets"), exist_ok=True)
    os.makedirs(run_dir, exist_ok=True)
    link = os.path.join(run_dir, "datasets")
    if not os.path.exists(link):
        os.symlink(os.path.join(STORAGE, "datasets"), link)
    cfg = cfg_mod.FrameworkConfig.load()
    cfg.storage.root = run_dir
    cfg_mod.set_config(cfg)


def stream_worker(run_dir: str) -> dict:
    """The streamed jobs with the double buffer on and off, in turns."""
    sys.path.insert(0, os.getcwd())
    import time

    import numpy as np
    import torch
    from cs230_distributed_machine_learning_tpu_torch import MLTaskManager
    from cs230_distributed_machine_learning_tpu_torch.data.stage_cache import STAGE_CACHE
    from cs230_distributed_machine_learning_tpu_torch.obs import REGISTRY

    _use_storage(run_dir)
    manager = MLTaskManager()
    assert manager.device.type == "cuda"
    os.environ.update(STREAM_VALVES)

    def counters():
        out = {k: REGISTRY.counter(f"tpuml_stream_{k}_total").value()
               for k in ("blocks", "upload_seconds", "wait_seconds")}
        out["uploads"] = sum(v for k, v in STAGE_CACHE.uploads_by_key().items() if "block" in k)
        return out

    def run(name, double_buffer):
        search, dataset, n = _job(name)
        os.environ["CS230_STREAM_DOUBLE_BUFFER"] = double_buffer
        before = counters()
        t0 = time.perf_counter()
        status = manager.train(search, dataset, {"random_state": 42}, timeout=1200)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res = status["job_result"]
        assert status["job_status"] == "completed" and not res["failed"], name
        assert len(res["results"]) == n, (name, len(res["results"]))
        after = counters()
        return {"wall_s": wall, **{k: after[k] - before[k] for k in after},
                "scores": [r["mean_cv_score"] for r in res["results"]]}

    out = {"tree": os.getcwd(), "valves": STREAM_VALVES, "runs": {}}
    for name in STREAM_JOBS:
        run(name, "1")
        runs = out["runs"][name] = {"1": [], "0": []}
        for mode in STREAM_TURNS:
            runs[mode].append(run(name, mode))
        assert all(r["blocks"] > 0 for m in runs.values() for r in m), name
        scores = np.array([r.pop("scores") for m in runs.values() for r in m])
        out.setdefault("max_score_diff", {})[name] = float(np.ptp(scores, axis=0).max())
    return out


def worker(run_dir: str, history: int, profile: bool) -> dict:
    """Run the jobs with the checkout in the working directory."""
    sys.path.insert(0, os.getcwd())
    import cProfile
    import gc
    import pstats
    import time

    import torch
    from cs230_distributed_machine_learning_tpu_torch import MLTaskManager
    from cs230_distributed_machine_learning_tpu_torch.runtime.coordinator import Coordinator

    _use_storage(run_dir)

    pauses = [0.0, 0.0, 0.0]
    started = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            started[0] = time.perf_counter()
        else:
            pauses[info["generation"]] += time.perf_counter() - started[0]

    gc.callbacks.append(on_gc)
    profiles = []
    run_job = Coordinator._run_job

    def profiled(self, *args, **kwargs):
        if not profiles or profiles[-1] is not None:
            return run_job(self, *args, **kwargs)
        prof = cProfile.Profile()
        prof.enable()
        try:
            return run_job(self, *args, **kwargs)
        finally:
            prof.disable()
            profiles[-1] = prof

    Coordinator._run_job = profiled
    manager = MLTaskManager()
    assert manager.device.type == "cuda"

    def run(name, mode):
        search, dataset, n = _job(name)
        if name == "scored_main":
            torch.cuda.empty_cache()
        os.environ["CS230_CURVES"] = mode
        try:
            before = list(pauses)
            t0 = time.perf_counter()
            status = manager.train(search, dataset, {"random_state": 42}, timeout=1200)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            del os.environ["CS230_CURVES"]
        res = status["job_result"]
        assert status["job_status"] == "completed" and not res["failed"], (name, mode)
        assert len(res["results"]) == n, (name, len(res["results"]))
        return wall, [b - a for a, b in zip(before, pauses)]

    t0 = time.perf_counter()
    for name in JOBS:
        run(name, "auto")
    out = {"tree": os.getcwd(), "warm_s": time.perf_counter() - t0, "history": history,
           "walls_s": {}, "gc_pause_s": {}, "gc_objects": {}, "profile": {}}
    for _ in range(history):
        run("main_10", "auto")
    for name in JOBS:
        walls = out["walls_s"][name] = {"0": [], "auto": []}
        gcs = out["gc_pause_s"][name] = {"0": [], "auto": []}
        objs = out["gc_objects"][name] = {"0": [], "auto": []}
        for mode in TURNS:
            objs[mode].append(len(gc.get_objects()))
            wall, paused = run(name, mode)
            walls[mode].append(wall)
            gcs[mode].append(paused)
    if profile:
        for name in JOBS:
            profiles.append(None)
            wall, _ = run(name, "auto")
            stats = pstats.Stats(profiles[-1]).stats.items()
            pkg = os.path.join(os.getcwd(), "cs230_distributed_machine_learning_tpu_torch")

            def rows(items):
                return [{"fn": f"{os.path.relpath(f, os.getcwd()) if f.startswith('/') else f}:"
                               f"{line}({fn})", "calls": nc, "own_s": tt, "cum_s": ct}
                        for (f, line, fn), (_, nc, tt, ct, _) in items]

            out["profile"][name] = {
                "wall_s": wall,
                "top_own_s": rows(sorted(stats, key=lambda kv: -kv[1][2])[:25]),
                "package_top_cum_s": rows(sorted(
                    (kv for kv in stats if kv[0][0].startswith(pkg)),
                    key=lambda kv: -kv[1][3])[:30])}
    out["journal_line_us"] = _journal_line_us(os.path.join(run_dir, "journal"))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", help="checkout roots, run in this order")
    ap.add_argument("--history", type=int, default=8,
                    help="main_10 runs before the timed turns")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--stream", action="store_true",
                    help="the streamed jobs with the double buffer on and off")
    ap.add_argument("--out", help="also write the JSON lines here")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        out = (stream_worker(args.worker) if args.stream
               else worker(args.worker, args.history, args.profile))
        print(json.dumps(out), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("job_ab: needs a CUDA card", file=sys.stderr)
        return 1
    here = os.path.abspath(__file__)
    lines = []
    for i, tree in enumerate(args.trees):
        cmd = [sys.executable, here, "--worker", os.path.join(STORAGE, f"run_{i}"),
               "--history", str(args.history)] + (["--profile"] if args.profile else []) + (
                   ["--stream"] if args.stream else [])
        proc = subprocess.run(cmd, cwd=os.path.abspath(tree), capture_output=True, text=True,
                              check=False)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr[-8000:], file=sys.stderr)
            return proc.returncode
        lines.append(proc.stdout.strip().splitlines()[-1])
        print(lines[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines + [smi]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
