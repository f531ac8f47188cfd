"""Time kernels B1-B6 of two checkouts of the port on one card, in turns.

    python3 kernel_ab.py --trees OLD NEW NEW OLD [--only hist,knn,mlp,logreg] [--out FILE]

Each entry of ``--trees`` is the root of a checkout (for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists, and ``.``). For each entry in order, a fresh process
imports that checkout's package, builds its ``csrc/logreg.cu``,
``csrc/hist.cu``, ``csrc/mlp.cu`` and ``csrc/knn.cu`` (and ``csrc/logreg_fused.cu``
where the checkout has it) and times the kernels
through their wrappers, whose signatures every checkout shares. The shapes, the input
builders and the timer are this checkout's ``ops/kernel_cases.py``, the
ones ``chip_smoke.py`` uses, loaded by path so that every tree is timed
on the same inputs from the same seeds:

- B4 ``level_histogram`` with integer stats at every ``HIST_SHAPES`` entry,
  and with float stats at every ``HIST_FLOAT_SHAPES``,
  ``HIST_FLOAT_DEEP_SHAPES`` and ``HIST_FLOAT_CROSSOVER_SHAPES`` entry
  (``hist_f32_*``; ``hist_f32_repeat``: whether a second launch in the
  process gave the first's digest); at the crossover shapes also each f32
  route's time and error (``hist_f32_crossover``; a checkout without the
  route aid: its one kernel's error) and one ``index_add_``'s time;
- B6 ``knn_topk`` at knn_main's launch shape (the staged KNN table, the
  job's 6 split masks, its first 4,096 rows as queries) at the grid's k
  and at k 300 (null for a checkout whose kernel refuses it);
- B5 ``epoch``, one full Adam epoch at every ``MLP_SHAPES`` entry on its
  72 lanes, and the widest shape again on one lane (a lane is one CTA, so
  the two times apart say how far the lanes contend for the card);
- B2 ``packed_nesterov_step`` and B1 ``packed_softmax_grad`` at
  ``LOGREG_SHAPE`` (bench.py's 1,024-trial dispatch on covertype);
- B3 ``masked_softmax_grad`` at every ``MASKED_SHAPES`` entry (the 784-
  feature search's 16 lanes on 4,096 rows, and a full-size search's 192
  lanes on 60,160 rows), and past 256 classes at ``PROBE_SCORED_SHAPE``
  (64 lanes, cp 304) and ``MASKED_RING_SHAPE`` (``masked_softmax_grad_ring``:
  1,000 classes on 768 features, where pass (a)'s clusters stream W^T);
- B1's wide form, ``packed_softmax_grad`` past the register-resident
  geometries, at every ``WIDE_SHAPES`` entry and ``WIDE_RING_SHAPE``
  (``packed_softmax_grad_wide_ring``) (``packed_softmax_grad_wide_*``:
  the route the checkout's wrapper takes there, its fused kernel or its two
  passes, with its largest error relative to the plain version's largest
  value in ``logreg_rel_err``).

Past 256 classes (B3 at ``probe_scored`` and ``ring``, the wide form's two
passes at ``probe_c300`` and ``ring``) each output is also held against its plain version
(``logreg_rel_err``) and a second launch (``logreg_repeat``: equal to the
bit), the launches a call are counted (``logreg_launches_per_call``), and a
``torch.profiler`` capture of three calls in the worker's own process gives
the device ms a call of each kernel (``logreg_device_ms_by_kernel``: the
W^T transpose, pass (a), pass (b), the range sum).

``--only`` times a subset of the four sources' kernels. Beside each time,
a SHA-256 digest of the kernel's output on fresh inputs
(``*_digest``): equal digests across checkouts mean outputs equal to the
bit. Prints one JSON line per entry and, last, the card's name and power
limit.
The KNN table is staged once under ``.smoke_storage/`` beside this script.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CASES = os.path.join(HERE, "cs230_distributed_machine_learning_tpu_torch", "ops",
                     "kernel_cases.py")
DATASETS = os.path.join(HERE, ".smoke_storage", "ab_datasets")


def _load_cases():
    spec = importlib.util.spec_from_file_location("kernel_ab_cases", CASES)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(only) -> dict:
    """Time the kernels of the checkout in the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch

    from cs230_distributed_machine_learning_tpu_torch.data.datasets import DatasetCache
    from cs230_distributed_machine_learning_tpu_torch.ops import cuda_build
    from cs230_distributed_machine_learning_tpu_torch.ops import cuda_hist as H
    from cs230_distributed_machine_learning_tpu_torch.ops import cuda_knn as K
    from cs230_distributed_machine_learning_tpu_torch.ops import cuda_logreg as R
    from cs230_distributed_machine_learning_tpu_torch.ops import cuda_mlp as M

    C = _load_cases()
    cuda_build.build([n for n in cuda_build.source_names() if n.split("_")[0] in only])
    dev = torch.device("cuda", 0)
    out = {"tree": os.getcwd(), "hist_ms": {}, "knn_ms": {}, "mlp_ms": {}, "logreg_ms": {},
           "hist_digest": {}, "knn_digest": {}, "mlp_digest": {}, "logreg_digest": {},
           "hist_f32_ms": {}, "hist_f32_digest": {}, "hist_f32_repeat": {}}
    gen = torch.Generator(device=dev).manual_seed(0)
    for tag, (L, n, d, n_bins, n_nodes, kk) in (C.HIST_SHAPES.items() if "hist" in only
                                                 else ()):
        local, xb, SC = C.hist_inputs(gen, dev, L, n, d, n_bins, n_nodes, kk, False,
                                      tag in C.HIST_SKEWED)
        out["hist_digest"][tag] = C.digest(H.level_histogram(
            local, xb, SC, n_nodes, n_bins, integer_stats=True))
        out["hist_ms"][tag] = C.time_ms(lambda: H.level_histogram(
            local, xb, SC, n_nodes, n_bins, integer_stats=True))
        del local, xb, SC
    gen = torch.Generator(device=dev).manual_seed(8)
    f32 = {**C.HIST_FLOAT_SHAPES, **C.HIST_FLOAT_DEEP_SHAPES, **C.HIST_FLOAT_CROSSOVER_SHAPES}
    for tag, (L, n, d, n_bins, n_nodes, kk) in (f32.items() if "hist" in only else ()):
        deep = tag in C.HIST_FLOAT_DEEP_SHAPES
        local, xb, SC = (C.deep_hist_inputs if deep else C.gb_hist_inputs)(
            gen, dev, L, n, d, n_bins, n_nodes)
        first = C.digest(H.level_histogram(local, xb, SC, n_nodes, n_bins))
        out["hist_f32_digest"][tag] = first
        out["hist_f32_repeat"][tag] = first == C.digest(
            H.level_histogram(local, xb, SC, n_nodes, n_bins))
        out["hist_f32_ms"][tag] = C.time_ms(lambda: H.level_histogram(
            local, xb, SC, n_nodes, n_bins))
        if tag in C.HIST_FLOAT_CROSSOVER_SHAPES:
            _crossover(out, tag, H, C, local, xb, SC, n_nodes, n_bins)
        del local, xb, SC
        torch.cuda.empty_cache()
    if "knn" not in only:
        return _worker_rest(out, only, C, dev, torch, M, R)
    _, X, W, _ = C.knn_table(DatasetCache(root=DATASETS), dev)
    Q = X[:C.KNN_QUERIES].contiguous()
    for k in C.KNN_GRID_KS + [C.KNN_DEVICE_LISTS_K]:
        try:
            out["knn_digest"][f"k{k}"] = C.digest(*K.knn_topk(Q, X, W, k))
        except ValueError:  # a kernel that keeps its lists in shared memory only
            if k <= 256:
                raise
            out["knn_ms"][f"k{k}"] = out["knn_digest"][f"k{k}"] = None
            continue
        out["knn_ms"][f"k{k}"] = C.time_ms(lambda: K.knn_topk(Q, X, W, k), reps=5, warmup=1)
    del X, Q, W
    torch.cuda.empty_cache()
    return _worker_rest(out, only, C, dev, torch, M, R)


def _crossover(out, tag, H, C, local, xb, SC, n_nodes, n_bins) -> None:
    """At a crossover shape: each f32 route's ms and launches and its
    error against the plain version (a checkout with the route aid), and
    one index_add_'s ms (``hist_library_ms``, the smoke's library time)."""
    import torch

    row = out.setdefault("hist_f32_crossover", {})[tag] = {}
    ref = H.level_histogram_reference(local, xb, SC, n_nodes, n_bins)
    scale = float(ref.abs().max())
    if hasattr(H, "level_histogram_f32_route"):
        L, d, kk = local.shape[0], xb.shape[1], SC.shape[-1]
        row["picked"] = H.f32_plan(L, local.shape[1], d, n_bins, n_nodes, kk).route
        for route in ("dense", "page"):
            got = H.level_histogram_f32_route(local, xb, SC, n_nodes, n_bins, route)
            row[route] = {
                "ms": C.time_ms(lambda: H.level_histogram_f32_route(
                    local, xb, SC, n_nodes, n_bins, route), reps=5, warmup=1),
                "max_rel_err": float((got - ref).abs().max()) / scale,
                "launches": H.f32_plan(L, local.shape[1], d, n_bins, n_nodes, kk,
                                       route).launches}
            del got
    else:
        got = H.level_histogram(local, xb, SC, n_nodes, n_bins)
        row["max_rel_err"] = float((got - ref).abs().max()) / scale
        del got
    del ref
    torch.cuda.empty_cache()
    row["library_ms"] = C.hist_library_ms(local, xb, SC, n_nodes, n_bins)[0]


def _worker_rest(out, only, C, dev, torch, M, R) -> dict:
    """B5, then B1-B3, where ``only`` names them."""
    if "mlp" not in only:
        return _worker_logreg(out, only, C, dev, torch, R)
    gen = torch.Generator(device=dev).manual_seed(5)
    runs = [(tag, C.MLP_LANES, shape) for tag, shape in C.MLP_SHAPES.items()]
    runs.append(("784-512-10_one_lane", 1, C.MLP_SHAPES["784-512-10"]))
    for tag, L, (dims, bs, steps) in runs:
        Xs, Ys, Wl, lr, alpha, params = C.mlp_inputs(gen, dev, dims, bs, steps, L)
        state = M.epoch_state(params, L, "adam")
        kw = dict(dims=dims, act="relu", bs=bs, n_batches=steps, classification=True)
        out["mlp_digest"][tag] = C.digest(*M.epoch(
            Xs, Ys, Wl, lr, alpha, 0, [t.clone() for t in state], **kw))
        out["mlp_ms"][tag] = C.time_ms(lambda: M.epoch(
            Xs, Ys, Wl, lr, alpha, 0, state, **kw), reps=3, warmup=1)
        del Xs, Ys, Wl, state
        torch.cuda.empty_cache()
    return _worker_logreg(out, only, C, dev, torch, R)


def _past_256(out, key, fn, ref, counter, R, C, torch) -> None:
    """At a shape past 256 classes: the output against its plain version
    ``ref`` and a second launch, the launches of one call (``counter`` in
    the checkout's launch counts) and the device ms by kernel."""
    before = R.LAUNCHES[counter]
    got = fn()
    torch.cuda.synchronize()
    out.setdefault("logreg_launches_per_call", {})[key] = R.LAUNCHES[counter] - before
    again = fn()
    out.setdefault("logreg_repeat", {})[key] = bool(torch.equal(got, again))
    out["logreg_rel_err"][key] = float((got - ref).abs().max() / ref.abs().max())
    del got, again
    out.setdefault("logreg_device_ms_by_kernel", {})[key] = C.device_ms_by_kernel(fn)


def _worker_logreg(out, only, C, dev, torch, R) -> dict:
    if "logreg" not in only:
        return out
    gen = torch.Generator(device=dev).manual_seed(0)
    n_pad, dpp, c, S, n_wb = C.LOGREG_SHAPE
    t = C.LOGREG_STEP_T
    Ab, Wt, Wp, y2, WSP, done, step, Cb, maxit, pen = C.logreg_inputs(
        gen, dev, n_pad, dpp, c, S, n_wb)
    rest = (y2, WSP, t, done, step, Cb, maxit, pen)
    out["logreg_digest"]["packed_nesterov_step"] = C.digest(*R.packed_nesterov_step(
        Ab, Wt.clone(), Wp.clone(), *rest, c=c, S=S, lam=1.0))
    Wk, Wpk = Wt.clone(), Wp.clone()  # the step updates these in place
    out["logreg_ms"]["packed_nesterov_step"] = C.time_ms(lambda: R.packed_nesterov_step(
        Ab, Wk, Wpk, *rest, c=c, S=S, lam=1.0))
    del Wk, Wpk
    Wb = Wt.to(torch.bfloat16)
    out["logreg_digest"]["packed_softmax_grad"] = C.digest(
        R.packed_softmax_grad(Ab, Wb, y2, WSP, c=c, S=S))
    out["logreg_ms"]["packed_softmax_grad"] = C.time_ms(
        lambda: R.packed_softmax_grad(Ab, Wb, y2, WSP, c=c, S=S))
    del Ab, Wt, Wp, Wb, rest
    torch.cuda.empty_cache()
    out["logreg_rel_err"] = {}
    gen = torch.Generator(device=dev).manual_seed(3)
    masked = {**C.MASKED_SHAPES, "probe_scored": C.PROBE_SCORED_SHAPE,
              "ring": C.MASKED_RING_SHAPE}
    for tag, (lanes, n3, dpp3, cp, c3) in masked.items():
        dp = C.PROBE_SCORED_DP if tag == "probe_scored" else None
        Ab, Wl, y2, wm = C.masked_inputs(gen, dev, lanes, n3, dpp3, cp, c3, dp=dp)
        key = f"masked_softmax_grad_{tag}"
        out["logreg_digest"][key] = C.digest(R.masked_softmax_grad(Ab, Wl, y2, wm, c=c3))
        out["logreg_ms"][key] = C.time_ms(lambda: R.masked_softmax_grad(Ab, Wl, y2, wm, c=c3))
        if c3 > 256:
            _past_256(out, key, lambda: R.masked_softmax_grad(Ab, Wl, y2, wm, c=c3),
                      R.masked_softmax_grad_reference(Ab, Wl, y2, wm, c=c3),
                      "masked_softmax_grad", R, C, torch)
        del Ab, Wl, y2, wm
        torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(19)
    for tag, (n_pad, dpp, c, S, n_wb) in {**C.WIDE_SHAPES, "ring": C.WIDE_RING_SHAPE}.items():
        Ab, W, _, y2, WSP, *_ = C.logreg_inputs(gen, dev, n_pad, dpp, c, S, n_wb)
        Wb = W.to(torch.bfloat16)
        del W
        key = f"packed_softmax_grad_wide_{tag}"
        got = R.packed_softmax_grad(Ab, Wb, y2, WSP, c=c, S=S)
        out["logreg_digest"][key] = C.digest(got)
        ref = R.packed_softmax_grad_reference(Ab, Wb, y2, WSP, c=c, S=S)
        out["logreg_rel_err"][key] = float((got - ref).abs().max() / ref.abs().max())
        del got
        out["logreg_ms"][key] = C.time_ms(lambda: R.packed_softmax_grad(Ab, Wb, y2, WSP, c=c, S=S))
        if c > 256:
            _past_256(out, key, lambda: R.packed_softmax_grad(Ab, Wb, y2, WSP, c=c, S=S), ref,
                      "packed_softmax_grad_wide", R, C, torch)
        del Ab, Wb, y2, WSP, ref
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", help="checkout roots, timed in this order")
    ap.add_argument("--only", default="hist,knn,mlp,logreg",
                    help="the sources whose kernels to time (comma-separated)")
    ap.add_argument("--out", help="also write the JSON lines here")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    only = [x for x in args.only.split(",") if x]
    if args.worker:
        print(json.dumps(worker(only)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 1
    here = os.path.abspath(__file__)
    lines = []
    for tree in args.trees:
        proc = subprocess.run([sys.executable, here, "--worker", "--only", ",".join(only)],
                              cwd=os.path.abspath(tree),
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
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
