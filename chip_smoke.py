"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; the first that fails ends the run with a
non-zero exit and no result line:

1. env      torch / CUDA versions and the card (name, power limit).
2. build    nvcc builds csrc/*.cu for sm_90a (seconds, ptxas report).
3. kernels  each CUDA kernel against its plain PyTorch version on the
            card at the main path's shapes (covertype: n_pad 116,736,
            dpp 64, 7 classes, 6 splits, 1 and 8 trial blocks; the
            784-feature lane kernel B3 at dpp 896 on the wide phase's 16
            lanes and 4,096 rows and on wide_full's 192 lanes and 60,160
            rows, and at dpp 1,152): max|err| / max|ref| < 5e-3, the fused
            step's frozen columns exact, two launches of B1, B2 and B3
            each equal to the bit, B2 equal to the bit to B1's gradient
            through its epilogue, B3's padded classes exactly 0, median ms
            by CUDA events beside the
            plain version's ms and the card's bound (bytes, bf16 products,
            f32 operations and the softmax's exponentials on the SFUs at
            16 a clock an SM, whichever takes longest).
4. data     stages the builtin covertype dataset (116,202 x 54, 7 classes).
5. main     MLTaskManager() on the card trains bench.py's job, uncut
            (RandomizedSearchCV(LogisticRegression(max_iter=200), C ~
            loguniform(1e-3, 1e2), tol in {1e-4, 1e-3}, n_iter=1000, cv=5,
            random_state=0) on covertype: one 1024-lane dispatch of 8
            packed blocks), once with CS230_FUSED_STEP=auto (fused step
            kernel) and once with legacy (gradient kernel); launch counts
            are zeroed before and read after each run. Both must complete
            all 1000 trials with finite scores, launch their kernel, agree
            on best_params_ and on every mean_cv_score within 2e-3.
   main_profile  the same job cut to max_iter 10: four runs in turns
            (legacy, auto, auto, legacy) for the walls, then one of each
            traced by torch.profiler: device busy share, device time by
            kernel, host time by operation.
6. wide     a 784-feature, 10-class LogReg search (n = 4096) through the
            generic nesterov driver: the masked lane kernel must launch.
7. reference  a small search (5,000 rows) on the card and on the CPU
            (plain versions): every mean_cv_score within 2e-3.
8. rf_main  MLTaskManager() on the card trains the repo's scaling-curve
            job, RandomForestClassifier(n_estimators=100, random_state=42)
            as a plain estimator, on the 10 % covertype fraction (11,620
            rows, drawn and staged as benchmarks/scaling_curve.py does):
            deep arena, 4 chunks of 25 trees; kernel B4 must launch
            22 levels x 100 trees = 2,200 times.
9. rf_full  the same estimator on the uncut covertype table (116,202
            rows): 100 chunks of 1 tree, 2,400 launches of B4.
   rf_profile after each: one tree of the job under torch.profiler (wall,
            device-busy share, device time by kernel).
10. rf_reference  two small RF searches, on the card and on the CPU (plain
            versions): iris (complete builder) and a 3,000-row synthetic
            through the chunked deep arena; best_params_ equal and every
            mean_cv_score within 1e-6.

11. kernels_mlp  B5 (the MLP epoch kernel) against its plain version with
            bf16 operands, on 72 lanes (one config-5 dispatch: 12 trials x
            6 splits) at 784-512-10 with batch 256 and 784-256-128-10 with
            batch 128: one step and an 8-step epoch from the Glorot init
            under Adam and SGD, held to MLP_LIMITS (its comment says why
            they are what they are), then a full Adam epoch (234 / 468
            steps) timed beside the plain version and the bound.
12. mlp_main  MLTaskManager() on the card trains BASELINE config 5, uncut:
            RandomizedSearchCV(MLPClassifier(max_iter=30, random_state=0),
            hidden_layer_sizes x learning_rate_init x alpha x batch_size,
            n_iter=100, cv=5, random_state=0) on synthetic_60000x784x10;
            every trial finite, B5 launched 30 times per bucket chunk.
13. mlp_reference  a small MLP search (4,096 rows) on the card and on the
            CPU (the plain version in f32): every mean_cv_score within 0.02,
            best_params_ equality reported.
    wide_full  RandomizedSearchCV(LogisticRegression(max_iter=100), C ~
            loguniform(1e-3, 1e2), n_iter=32, cv=5, random_state=0) on the
            synthetic_60000x784x10 table mlp_main staged (no staging of its
            own): one generic nesterov dispatch of 192 lanes, B3 launched
            100 times; then the same job under CS230_MASKED_GRAD=xla (torch
            ops on the card, no kernel): every mean_cv_score within 2e-3,
            best_params_ equal unless the top two scores are that close.
14. kernels_knn  stages synthetic_200000x54x7 and holds B6 (the KNN top-k)
            against its plain version at knn_main's launch shape (rows
            0-4,095 of the table as queries, the job's 6 split masks, k 5
            and 25, and k 300, whose lists live in device memory):
            distances within KNN_D2_TOL of max(qsq + tsq), the same
            neighbour sets wherever the plain k-th and (k+1)-th distances
            are further apart; then integer data (exact ties, a lane with
            fewer rows than k, k 256 and 300) equal to the bit, and shapes
            off the tile grid. Times beside the bound and torch.cdist + a
            masked topk.
15. knn_main  MLTaskManager() on the card trains GridSearchCV(
            KNeighborsClassifier(), {n_neighbors: [5, 25], weights:
            [uniform, distance]}, cv=5) on that table: 4 buckets, each
            49 query chunks of 4,096 rows; B6 must launch chunked_plan's
            count (196), all 4 trials finite.
16. knn_reference  5,000-row classifier and regressor KNN grids on the
            card and on the CPU, with CS230_FORCE_PACKED=1 (B6 on the
            card, its plain version on the CPU) and without (the generic
            path on both): mean_cv_score within 2e-3 (r2: 1e-4).

Then the other tree families (slice 8):

17. kernels_hist (float rows)  B4's f32 mode at the boosting levels
            (HIST_FLOAT_SHAPES: gb_main's root and last level, 168 lanes x
            116,202 rows, and config 4's root, 12 lanes x 867 rows): within
            1e-5 of the max, whether two launches agree to the bit
            (recorded), ms beside the plain version, one index_add_ and the
            bound.
18. gb_titanic  BASELINE config 4, uncut: the titanic builtin downloaded,
            preprocessed with TITANIC_PREPROCESS, GridSearchCV(
            GradientBoostingRegressor(random_state=0), n_estimators [50,
            100] x learning_rate [0.05, 0.1], cv=5) on the card and on the
            CPU; B4 launched (50 + 100) x 3 = 450 times (from the plan).
19. gb_main  GridSearchCV(GradientBoostingClassifier(n_estimators=50),
            learning_rate [0.05, 0.1, 0.2, 0.5], cv=5) on covertype, twice:
            the reference's plan (3 chunks of 17 stages), 168 lanes, 150
            launches; whether the second run repeats the scores, recorded.
20. gb_reference  boosting grids with subsample 0.8 on a 3,000-row
            covertype draw, card vs CPU (the classifier through
            _run_chunked), then one stage of each on both devices split by
            split but at close calls (ops/tree_checks.py).
21. trees_reference  RandomForestRegressor at 33 and 64 trees,
            DecisionTreeClassifier / -Regressor deep and at depth 4,
            GaussianNB, card vs CPU (TREE_SEARCH_TOL says why each bound).

Then every scorer and the last families (slice 9):

22. scored_main  bench.py's search cut to 256 trials with scoring=
            "neg_log_loss" on covertype: a scored job leaves the packed path
            (as in the reference), so one generic nesterov dispatch of 256 x
            6 lanes launches B3 200 times and B1 / B2 never; then the same
            job under CS230_MASKED_GRAD=xla: every mean_cv_score within
            SCORED_MAIN_TOL, best_params_ equal unless the top two are that
            close.
23. scoring_reference  a scored GridSearchCV of every family (label,
            margin and probability scorers where the family has them; the
            transformers unscored) on the card and on the CPU, each within
            SCORED_TOL; the card's run launches exactly its family's kernel
            (LogReg on the 784-feature table: B3; trees and boosting: B4;
            KNN under CS230_FORCE_PACKED=1: B6) and none where the family
            has none, so never B1, B2 or B5 under a scorer; then the
            refusals (a binary-only scorer on 7 classes, a probability
            scorer on KNN and on SVC) failing their subtasks with the reason.
24. svc_matrix  SVC(), cv 5, on the 10 % covertype fraction (11,620 rows,
            benchmarks/model_matrix.py's row): the exact dual, 21 OvO
            machines x 6 lanes in one ascent; wall, the slowest lane's stop
            step, mean_cv_score beside the reference's recorded one; then
            SVC card vs CPU on 3,000 rows.
25. svc_nystrom  SVC() on the uncut covertype table (benchmarks/
            svc_quality.py's point): the Nyström primal, 4,096 landmarks,
            1,200 steps; wall and mean_cv_score; then the Nyström path
            card vs CPU on 32,768 rows at 4,096 landmarks (NYSTROM_CUT).

Then the winner artifact:

26. artifacts  the winners of main_auto (LogReg), rf_full (RF-100 uncut),
            gb_main, knn_main, mlp_main (config 5) and svc_matrix, each
            through manager.download_best_model (refitted once on the card
            on its holdout split's training rows, written as
            <subtask_id>_model.pkl), load_best_model(as_sklearn=False) and
            predict_with_artifact on the holdout's eval rows on the card,
            every launch count zeroed before and read after: B3 once a
            solver step of the LogReg refit, B4 once a level of every tree
            or stage of the forest and boosting refits, B6 once for the KNN
            prediction; B1, B2 and B5 never, and nothing on the MLP and SVC
            paths; a second download returns the cached path; the refit's
            holdout accuracy is the winner's reported one within
            ARTIFACT_JOBS' limit; each refit's seconds.
27. artifact_reference  the same refits at ARTIFACT_CUTS' cut on the card
            and on the CPU, each predicting its eval rows (the MLP: all of
            config 5's 60,000 rows): accuracies within the card-vs-CPU
            limits (SCORED_TOL).
28. kernels_artifact  B3 at one lane at the covertype refit, B4 at one
            lane at rf_full's widest level and at the boosting refit's root
            (7 lanes, float stats), B6 at the KNN prediction (one lane,
            40,000 queries, 200,000 rows, the winner's k) against their plain
            versions, timed: each kernel's ``other_paths`` entry on the
            kernels line.

The kernels phase also holds B3 at scored_main's shape (1,536 lanes,
n_pad 116,224, dpp 128 of which the 55 real columns are nonzero, cp 16,
c 7; its R^T scratch past 2^31 elements) against its plain version run
256 lanes at a time, and B4 (the tree level histogram) against its
plain version at the deep levels of rf_main (6 lanes, 11,620 rows, 128
nodes, 24 and 48 bins, 7 classes) and at rf_full's widest level (116,202
rows, 1536 nodes, 16 bins), once with uniform and once with geometric
node sizes: integer stats bit-exact, float stats within 1e-5 of the max,
with the kernel's, the plain version's and one ``index_add_``'s median ms
and the bound.

Then a line of each kernel's ``earlier_ms`` (the figure PERF.md's kernel
table held for its earlier design, not measured in this run), the
kernels line (every number measured in this run, but the bound, which it
computes from this run's inputs), the nvidia-smi line, and the result line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
when CUDA is unavailable. Needs one card.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "cs230_distributed_machine_learning_tpu_torch"
sys.path.insert(0, ROOT)
# the kernels' check and timing shapes, input builders and timer
from cs230_distributed_machine_learning_tpu_torch.ops.kernel_cases import (  # noqa: E402
    HIST_FLOAT_REFIT_SHAPES, HIST_FLOAT_SHAPES, HIST_REFIT_SHAPES, HIST_SHAPES, HIST_SKEWED,
    KNN_DATASET, KNN_DEVICE_LISTS_K, KNN_GRID_KS, KNN_PREDICT_QUERIES, KNN_QUERIES,
    LOGREG_SHAPE, LOGREG_STEP_T, MASKED_REFIT_SHAPE, MASKED_SCORED_DP, MASKED_SCORED_SHAPE,
    MASKED_SHAPES,
    MLP_CHECK_STEPS, MLP_EPOCH_LR,
    MLP_LANES, MLP_LIMITS, MLP_SHAPES, digest, gb_hist_inputs, hist_inputs, logreg_inputs,
    masked_inputs, mlp_check, mlp_inputs, step_via_gradient, time_ms)
from cs230_distributed_machine_learning_tpu_torch.ops.kernel_cases import (  # noqa: E402
    knn_table as _knn_table)
SOURCES = {"logreg": f"{PKG}/csrc/logreg.cu", "hist": f"{PKG}/csrc/hist.cu",
           "mlp": f"{PKG}/csrc/mlp.cu", "knn": f"{PKG}/csrc/knn.cu"}
TOL = 5e-3
HIST_FLOAT_TOL = 1e-5
MLP_SEARCH_TOL = 0.02
#: each kernel's ms at the kernels line's shapes as PERF.md's kernel table
#: stood before its current design; printed on a line of its own, apart
#: from the kernels line, whose numbers this run measures
EARLIER_MS = {"packed_softmax_grad": 18.35, "packed_nesterov_step": 18.51,
              "masked_softmax_grad": 27.74, "level_histogram": 0.105,
              "mlp_epoch": 913.5, "knn_topk": 28.41}
EARLIER_MS_SOURCE = ("PERF.md's kernel table before each kernel's current design (B1 and B3: "
                     "their first designs, B1 by chip_smoke.py, B3 at wide_full's shape by "
                     "kernel_ab.py; NVIDIA H100 80GB HBM3, 700.00 W); not measured in this run")
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 outside
# them, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# f32 operations per packed (row, column) element of the grouped softmax and
# residual outside the exponential: max, subtract, sum, scale, subtract
# one-hot, weight; the exponential runs on the SFUs
SOFTMAX_OPS = 6
# the SFUs' exponentials a clock an SM (H100: 16), and its SMs
SFU_PER_CLOCK = 16
SMS = 132
#: examples/titanic_preprocess.yaml as the dict the manager's preprocess
#: takes (the card's machine may have no PyYAML; tests hold the two equal)
TITANIC_PREPROCESS = {
    "drop_null": False,
    "impute": {"Age": "median", "Embarked": "mode"},
    "outliers": {"Age": "iqr", "Fare": "clip"},
    "drop_columns": ["Cabin", "Ticket", "Name", "PassengerId"],
    "drop_duplicates": True,
    "categorical": [{"Sex": "onehot"}, {"Embarked": "onehot"}, {"Pclass": "onehot"}],
    "scale": {"method": "standard", "columns": ["Age", "Fare", "SibSp", "Parch"]},
    "target_column": "Survived",
}
#: SM clock (Hz) of the exponential term: the card's maximum, as nvidia-smi
#: reports it (set in phase_env), else the H100 SXM's 1.98 GHz
SM_CLOCK_HZ = [1.98e9]


#: job ids of the smoke's searches by phase, for the artifact phases
JOBS = {}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def errors(got, ref):
    """(max |got - ref|, that over max |ref|)."""
    got, ref = got.float(), ref.float()
    err = float((got - ref).abs().max())
    return err, err / (float(ref.abs().max()) + 1e-12)


def bound_terms(nbytes: float, mm_flops: float, f32_ops: float, exps: float = 0.0) -> dict:
    """Each unit's least time (ms) for the work: the bytes over HBM
    bandwidth, the bf16 products over the tensor cores' peak, the f32
    operations over the f32 peak, the exponentials over the SFUs' rate."""
    return {"bytes": 1e3 * nbytes / PEAK_BYTES, "bf16": 1e3 * mm_flops / PEAK_BF16,
            "f32": 1e3 * f32_ops / PEAK_F32,
            "sfu": 1e3 * exps / (SFU_PER_CLOCK * SMS * SM_CLOCK_HZ[0])}


def bound_ms(nbytes: float, mm_flops: float, f32_ops: float, exps: float = 0.0):
    """Least time for the work on this card: the largest of the units'
    times (they run side by side, so their times overlap). Returns (ms,
    bound_by: "bytes" or "operations", the binding unit)."""
    terms = bound_terms(nbytes, mm_flops, f32_ops, exps)
    unit = max(terms, key=terms.get)
    return terms[unit], ("bytes" if unit == "bytes" else "operations"), unit


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phases


def phase_env() -> dict:
    info = {
        "phase": "env",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(),
        "nvidia_smi": nvidia_smi(),
    }
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=False).stdout.strip().splitlines()
    if clock and clock[0].strip().isdigit():
        SM_CLOCK_HZ[0] = float(clock[0]) * 1e6
    info["sm_clock_max_hz"] = SM_CLOCK_HZ[0]
    emit(info)
    return info


def phase_build() -> None:
    from cs230_distributed_machine_learning_tpu_torch.ops import (
        cuda_build,
        cuda_hist,
        cuda_knn,
        cuda_logreg,
        cuda_mlp,
    )

    t0 = time.perf_counter()
    compiled = cuda_build.build()  # every csrc/*.cu, one nvcc each, in parallel
    assert all(cuda_build.library_path(name).exists() for name in SOURCES), compiled
    lib = cuda_logreg._lib()
    # B3: the Python plan mirrors the library's, field for field
    import ctypes

    plan = (ctypes.c_longlong * len(cuda_logreg.MASKED_PLAN_FIELDS))()
    for shape in ((4096, 896, 16, 16), (60_160, 896, 16, 192), (4096, 1152, 16, 16),
                  (512, 128, 128, 3), (4096, 896, 160, 16)):
        assert lib.logreg_masked_plan(*shape, plan) == 1, shape
        mirror = cuda_logreg.masked_plan(*shape)
        assert list(plan) == [mirror[k] for k in cuda_logreg.MASKED_PLAN_FIELDS], shape
    # B1 / B2: every instantiated geometry exists in the library, its layout as mirrored
    for n1, L, mt in sorted(cuda_logreg.STEP_GEOMETRIES):
        assert lib.logreg_step_geometry_ok(n1, L, mt), (n1, L, mt)
        lay = cuda_logreg.step_layout(64 * mt, n1)
        assert lib.logreg_step_smem_bytes(64 * mt, n1) == lay["total"], (n1, mt)
        assert lib.logreg_step_stages(64 * mt, n1) == lay["stages"], (n1, mt)
    assert not lib.logreg_step_geometry_ok(112, 16, 1)
    for args in ((4, 54, 16, 7), (1, 2, 48, 7), (1, 5, 256, 16)):
        assert cuda_hist._lib().hist_page_bytes(*args) == cuda_hist.page_bytes(*args)
    for args in ((6, 116_202, 1536, 767), (6, 11_620, 128, 127), (1, 5, 1, 1)):
        assert cuda_hist._lib().hist_scratch_ints(*args) == cuda_hist.scratch_ints(*args)
    for dims, bs in (((784, 512, 10), 256), ((784, 256, 128, 10), 128), ((5, 3, 7, 1), 40)):
        got = cuda_mlp._lib().mlp_scratch_floats(cuda_mlp._dims_array(dims), len(dims) - 1, bs)
        assert got == cuda_mlp.scratch_floats(dims, bs), (dims, got)
    assert cuda_knn._lib().knn_max_shared_k() == cuda_knn.SHARED_LISTS_MAX_K
    assert cuda_knn._lib().knn_max_group() == cuda_knn.MAX_GROUP
    assert cuda_knn._lib().knn_max_ranges() == cuda_knn.MAX_RANGES
    for k in (1, 5, 25, 45, cuda_knn.SHARED_LISTS_MAX_K, 300):
        for G in (1, 6, 16):
            for bq in cuda_knn.QUERY_BLOCKS:
                assert (cuda_knn._lib().knn_smem_bytes(k, G, bq)
                        == cuda_knn.smem_bytes(k, G, bq)), (k, G, bq)
    ptxas = [ln.strip() for name in sorted(SOURCES)
             for ln in cuda_build.build_log(name).splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": sorted(compiled), "arch": "sm_90a", "ptxas": ptxas})


def phase_kernels(dev) -> dict:
    """Every kernel vs its plain version at the main path's shapes."""
    from cs230_distributed_machine_learning_tpu_torch.ops import cuda_logreg as K

    gen = torch.Generator(device=dev).manual_seed(0)
    n_pad, dpp, c, S, _ = LOGREG_SHAPE
    t = LOGREG_STEP_T
    rows = {}
    for n_wb in (1, LOGREG_SHAPE[4]):
        Ab, W, Wp, y2, WSP, done, step, Cb, maxit, pen = logreg_inputs(
            gen, dev, n_pad, dpp, c, S, n_wb)
        NB = W.shape[2]
        mm = 4.0 * n_pad * dpp * NB * n_wb
        exps = float(n_pad) * NB * n_wb  # one a (row, class, lane)
        f32_ops = SOFTMAX_OPS * exps
        # B1: packed softmax-Gram gradient; two launches equal to the bit
        Wb = W.to(torch.bfloat16)
        got = K.packed_softmax_grad(Ab, Wb, y2, WSP, c=c, S=S)
        again = K.packed_softmax_grad(Ab, Wb, y2, WSP, c=c, S=S)
        ref = K.packed_softmax_grad_reference(Ab, Wb, y2, WSP, c=c, S=S)
        abs1, err1 = errors(got, ref)
        repeat1 = bool(torch.equal(got, again))
        digest1 = digest(got)  # kernel_ab.py prints the same for its inputs
        assert err1 < TOL, f"packed_softmax_grad n_wb={n_wb}: {err1}"
        assert repeat1, f"packed_softmax_grad n_wb={n_wb}: two launches differ"
        del got, again, ref
        ms1 = time_ms(lambda: K.packed_softmax_grad(Ab, Wb, y2, WSP, c=c, S=S))
        plain1 = time_ms(lambda: K.packed_softmax_grad_reference(Ab, Wb, y2, WSP, c=c, S=S), reps=3)
        nbytes1 = Ab.numel() * 2 + Wb.numel() * 2 + y2.numel() * 4 + WSP.numel() * 4 + W.numel() * 4
        b1, by1, unit1 = bound_ms(nbytes1, mm, f32_ops, exps)
        rows[("packed_softmax_grad", n_wb)] = dict(
            max_abs_err=abs1, max_rel_err=err1, ms=ms1, plain_ms=plain1,
            bound_ms=b1, bound_by=by1, bound_unit=unit1,
            bound_terms_ms=bound_terms(nbytes1, mm, f32_ops, exps),
            repeat_bit_equal=repeat1, digest=digest1)

        # B2: fused Nesterov step, in place; two launches on the same inputs
        # must agree to the bit
        W_ref, Wp_ref, g_ref = K.packed_nesterov_step_reference(
            Ab, W, Wp, y2, WSP, t, done, step, Cb, maxit, pen, c=c, S=S, lam=1.0)
        runs = []
        for _ in range(2):
            Wk, Wpk = W.clone(), Wp.clone()
            runs.append(K.packed_nesterov_step(Ab, Wk, Wpk, y2, WSP, t, done, step, Cb,
                                               maxit, pen, c=c, S=S, lam=1.0))
        torch.cuda.synchronize()
        Wk, Wpk, gk = runs[0]
        errs = [errors(Wk, W_ref), errors(Wpk, Wp_ref), errors(gk, g_ref)]
        abs2, err2 = max(e[0] for e in errs), max(e[1] for e in errs)
        assert err2 < TOL, f"packed_nesterov_step n_wb={n_wb}: {err2}"
        active = ((t < maxit) & (done == 0)).repeat(1, c)[:, None, :].expand_as(W)
        assert torch.equal(Wk[~active], W[~active]), "frozen W columns moved"
        assert torch.equal(Wpk[~active], Wp[~active]), "frozen Wp columns moved"
        repeat_equal = all(torch.equal(a, b) for a, b in zip(*runs))
        step_digest = digest(*runs[0])
        # B2 computes B1's gradient to the bit (one chain over the rows, the
        # same softmax): its update equals B1's gradient through its epilogue
        via_b1 = step_via_gradient(K, Ab, W, Wp, y2, WSP, t, done, step, Cb, maxit, pen,
                                   c=c, S=S, lam=1.0)
        b1_equal = all(torch.equal(a, b) for a, b in zip(runs[0], via_b1))
        del via_b1
        assert repeat_equal, f"packed_nesterov_step n_wb={n_wb}: two launches differ"
        assert b1_equal, f"packed_nesterov_step n_wb={n_wb}: differs from B1's gradient"
        del W_ref, Wp_ref, runs
        ms2 = time_ms(lambda: K.packed_nesterov_step(
            Ab, Wk, Wpk, y2, WSP, t, done, step, Cb, maxit, pen, c=c, S=S, lam=1.0))
        plain2 = time_ms(lambda: K.packed_nesterov_step_reference(
            Ab, W, Wp, y2, WSP, t, done, step, Cb, maxit, pen, c=c, S=S, lam=1.0), reps=3)
        nbytes2 = (Ab.numel() * 2 + 4 * W.numel() * 4 + y2.numel() * 4 + WSP.numel() * 4
                   + 5 * done.numel() * 4 + pen.numel() * 4)
        b2, by2, unit2 = bound_ms(nbytes2, mm, f32_ops + 8 * W.numel(), exps)
        rows[("packed_nesterov_step", n_wb)] = dict(
            max_abs_err=abs2, max_rel_err=err2, ms=ms2, plain_ms=plain2,
            bound_ms=b2, bound_by=by2, bound_unit=unit2,
            bound_terms_ms=bound_terms(nbytes2, mm, f32_ops + 8 * W.numel(), exps),
            repeat_bit_equal=repeat_equal, b1_bit_equal=b1_equal, digest=step_digest,
            geometry=K.step_geometry(dpp, c))
        del Ab, W, Wp, Wk, Wpk, Wb
        torch.cuda.empty_cache()

    # B3: the masked lane kernel at the wide phase's and wide_full's shapes,
    # then at dpp 1,152 (above the first design's cap)
    for tag in MASKED_SHAPES:
        rows[("masked_softmax_grad", tag)] = masked_kernel_row(K, gen, dev, tag,
                                                                *MASKED_SHAPES[tag])
    rows[("masked_softmax_grad", "dpp1152")] = masked_kernel_row(
        K, gen, dev, "dpp1152", 16, 4096, 1152, 16, 10)
    # scored_main's shape: 1,536 lanes at dpp 128, R^T past 2^31 elements;
    # the plain version runs 256 lanes at a time (all at once it would hold
    # ~60 GB of [lanes, rows, 16] temporaries)
    rows[("masked_softmax_grad", "scored_main")] = masked_kernel_row(
        K, gen, dev, "scored_main", *MASKED_SCORED_SHAPE, dp=MASKED_SCORED_DP, plain_lanes=256)
    emit({"phase": "kernels", "tolerance": TOL, "sm_clock_hz": SM_CLOCK_HZ[0],
          "rows": [{"kernel": k, "tag": n, **v} for (k, n), v in rows.items()]})
    rows.update(hist_kernel_rows(gen, dev))
    return rows


def device_ms_by_kernel(fn, calls: int = 3) -> dict:
    """Device ms a call of ``fn`` spends in each kernel (torch.profiler over
    ``calls`` calls after one warm-up); their sum beside the call's CUDA-
    event time shows how long the card waited on the host."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / 1e3 / calls for e in prof.key_averages()
            if e.self_device_time_total > 0}


def masked_kernel_row(K, gen, dev, tag, lanes, n_pad, dpp, cp, c, dp=None,
                      plain_lanes=0) -> dict:
    """B3 against its plain version at one shape: within TOL, two launches
    equal to the bit, padded classes (and padded columns) exactly 0; the
    kernel's and the plain version's median ms, the device ms of each of
    the call's kernels, and the bound: the rows, weights and gradient over
    the dp real columns and c real classes, the products and exponentials
    over them (the padding is the kernel's layout, not the function's
    work). ``dp`` < dpp zeroes the columns from dp on, as the nesterov
    path pads them; ``plain_lanes`` > 0 runs the plain version that many
    lanes at a time (lanes are independent; its time is the blocks' sum)."""
    dp = dp or dpp
    Ab, Wl, y2, wm = masked_inputs(gen, dev, lanes, n_pad, dpp, cp, c, dp=dp)
    got = K.masked_softmax_grad(Ab, Wl, y2, wm, c=c)
    again = K.masked_softmax_grad(Ab, Wl, y2, wm, c=c)
    step = plain_lanes or lanes

    def plain():
        return torch.cat([K.masked_softmax_grad_reference(
            Ab, Wl[i:i + step], y2, wm[:, i:i + step].contiguous(), c=c)
            for i in range(0, lanes, step)])

    ref = plain()
    abs3, err3 = errors(got, ref)
    repeat = bool(torch.equal(got, again))
    padded_zero = (float(got[:, :, c:].abs().max()) == 0.0
                   and (dp == dpp or float(got[:, dp:].abs().max()) == 0.0))
    out_digest = digest(got)  # kernel_ab.py prints the same for its inputs
    del again, ref
    torch.cuda.empty_cache()
    assert err3 < TOL, f"masked_softmax_grad {tag}: {err3}"
    assert repeat, f"masked_softmax_grad {tag}: two launches differ"
    assert padded_zero, f"masked_softmax_grad {tag}: padded classes not zero"
    ms = time_ms(lambda: K.masked_softmax_grad(Ab, Wl, y2, wm, c=c))
    plain_ms = time_ms(plain, reps=3)
    by_kernel = device_ms_by_kernel(lambda: K.masked_softmax_grad(Ab, Wl, y2, wm, c=c))
    nbytes = n_pad * dp * 2 + lanes * dp * c * (2 + 4) + y2.numel() * 4 + wm.numel() * 4
    exps = float(n_pad) * c * lanes
    mm = 4.0 * n_pad * dp * c * lanes
    bound, by, unit = bound_ms(nbytes, mm, SOFTMAX_OPS * exps, exps)
    del Ab, Wl, y2, wm, got
    torch.cuda.empty_cache()
    return dict(shape=dict(lanes=lanes, n_pad=n_pad, dpp=dpp, dp=dp, cp=cp, c=c),
                plan=K.masked_plan(n_pad, dpp, cp, lanes), max_abs_err=abs3,
                max_rel_err=err3, repeat_bit_equal=repeat, padded_zero=padded_zero,
                digest=out_digest, ms=ms, plain_ms=plain_ms, plain_lanes=step,
                device_ms_by_kernel=by_kernel,
                library_ms=None, bound_ms=bound,
                bound_by=by, bound_unit=unit,
                bound_terms_ms=bound_terms(nbytes, mm, SOFTMAX_OPS * exps, exps))


def hist_library_ms(local, xb, SC, n_nodes, n_bins) -> tuple:
    """The level histogram as one index_add_ (the PyTorch call that
    computes the same function; the port never calls it): flat (lane, node,
    feature, bin) cell per (row, feature) with its stats, built beforehand.
    Returns (its median ms, the adds this run's data needs: nonzero stats
    times features)."""
    L, d, kk = local.shape[0], xb.shape[1], SC.shape[-1]
    ok = (local >= 0) & (local < n_nodes)
    lanes, rws = ok.nonzero(as_tuple=True)
    cells = (((lanes * n_nodes + local[lanes, rws].long())[:, None] * d
              + torch.arange(d, device=local.device)) * n_bins + xb[rws].long()).reshape(-1)
    src = SC[lanes, rws].repeat_interleave(d, dim=0)
    out = torch.zeros((L * n_nodes * d * n_bins, kk), device=local.device)
    lib_ms = time_ms(lambda: out.index_add_(0, cells, src), reps=5)
    adds = int((SC[lanes, rws] != 0).sum()) * d
    del cells, src, out
    torch.cuda.empty_cache()
    return lib_ms, adds


def hist_kernel_rows(gen, dev, shapes=HIST_SHAPES) -> dict:
    """B4 against its plain version: integer stats bit-exact, float stats
    within HIST_FLOAT_TOL of the max. Times: the kernel, the plain version,
    and one index_add_ over precomputed flat indices (the PyTorch call
    that computes the same function: ``library_ms``; the port never calls
    it). Bound: the bytes the function must move, or its adds at the f32
    rate, whichever is larger."""
    from cs230_distributed_machine_learning_tpu_torch.ops import cuda_hist as H

    rows = {}
    for tag, (L, n, d, n_bins, n_nodes, kk) in shapes.items():
        skewed = tag in HIST_SKEWED
        local, xb, SC = hist_inputs(gen, dev, L, n, d, n_bins, n_nodes, kk, False, skewed)
        got = H.level_histogram(local, xb, SC, n_nodes, n_bins, integer_stats=True)
        ref = H.level_histogram_reference(local, xb, SC, n_nodes, n_bins)
        torch.cuda.synchronize()
        iabs, irel = errors(got, ref)
        exact = torch.equal(got, ref)
        assert exact, f"level_histogram {tag}: integer stats not bit-exact ({iabs})"
        del got, ref
        ms = time_ms(lambda: H.level_histogram(local, xb, SC, n_nodes, n_bins,
                                               integer_stats=True))
        plain = time_ms(lambda: H.level_histogram_reference(local, xb, SC, n_nodes, n_bins),
                        reps=3)
        lib_ms, adds = hist_library_ms(local, xb, SC, n_nodes, n_bins)
        nbytes = H.hist_bytes(L, n, d, kk, n_nodes, n_bins)
        t_bytes, t_ops = nbytes / PEAK_BYTES, adds / PEAK_F32
        bound = 1e3 * max(t_bytes, t_ops)

        fl, fx, fS = hist_inputs(gen, dev, L, n, d, n_bins, n_nodes, kk, True, skewed)
        fgot = H.level_histogram(fl, fx, fS, n_nodes, n_bins)
        fref = H.level_histogram_reference(fl, fx, fS, n_nodes, n_bins)
        fabs, frel = errors(fgot, fref)
        assert frel < HIST_FLOAT_TOL, f"level_histogram {tag}: float stats {frel}"
        largest = int(torch.bincount(local[0][(local[0] >= 0) & (local[0] < n_nodes)].long(),
                                     minlength=n_nodes).max())
        del fgot, fref, fl, fx, fS, local, xb, SC
        torch.cuda.empty_cache()
        rows[("level_histogram", tag)] = dict(
            shape=dict(lanes=L, rows=n, features=d, bins=n_bins, nodes=n_nodes, stats=kk,
                       skewed=skewed, largest_node_rows=largest),
            ctas=H.grid_ctas(n, n_nodes, d, n_bins, kk, L), integer_bit_exact=exact,
            max_abs_err=iabs, max_rel_err=irel, float_max_abs_err=fabs,
            float_max_rel_err=frel,
            ms=ms, plain_ms=plain, library_ms=lib_ms, bound_ms=bound,
            bound_by="bytes" if t_bytes >= t_ops else "operations")
    emit({"phase": "kernels_hist", "float_tolerance": HIST_FLOAT_TOL,
          "rows": [{"kernel": k, "tag": t, **v} for (k, t), v in rows.items()]})
    return rows


def phase_data(cfg) -> None:
    from cs230_distributed_machine_learning_tpu_torch.data.datasets import DatasetCache

    t0 = time.perf_counter()
    data = DatasetCache(root=cfg.storage.datasets_dir).get("covertype", "classification")
    assert data.X.shape == (116_202, 54) and data.n_classes == 7, data.X.shape
    emit({"phase": "data", "dataset": "covertype", "shape": list(data.X.shape),
          "n_classes": data.n_classes, "seconds": time.perf_counter() - t0})


def _search(n_iter, max_iter, cv, C=(1e-3, 1e2), tol=(1e-4, 1e-3)):
    """bench.py's ``RandomizedSearchCV(LogisticRegression(max_iter=...),
    {C: loguniform(...), tol: [...]}, n_iter, cv, random_state=0)`` as the
    model_details payload the manager takes in place of the scikit-learn
    objects (the port needs no scikit-learn)."""
    from scipy.stats import loguniform

    return {
        "model_type": "LogisticRegression",
        "search_type": "RandomizedSearchCV",
        "base_estimator_params": {"max_iter": max_iter},
        "param_distributions": {"C": loguniform(*C), "tol": list(tol)},
        "n_iter": n_iter,
        "random_state": 0,
        "cv_params": {"cv": cv},
    }


def _train(manager, search, dataset, kernel_name, n_trials):
    """One search through the manager with launch counts zeroed just
    before and read just after. Checks completion, trial count, finite
    scores and that ``kernel_name`` launched."""
    from cs230_distributed_machine_learning_tpu_torch.ops import cuda_logreg as K

    K.reset_launches()
    t0 = time.perf_counter()
    status = manager.train(search, dataset, {"random_state": 42}, timeout=900)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    assert status["job_status"] == "completed", status
    res = status["job_result"]
    assert not res["failed"], res["failed"][:1]
    assert len(res["results"]) == n_trials, len(res["results"])
    scores = [r["mean_cv_score"] for r in res["results"]]
    assert all(isinstance(s, float) and 0.0 <= s <= 1.0 for s in scores), scores[:5]
    assert launches[kernel_name] > 0, f"{kernel_name} never launched: {launches}"
    return status, wall, launches


def _scores(status):
    return {json.dumps(r["search_params"], sort_keys=True): r["mean_cv_score"]
            for r in status["job_result"]["results"]}


def phase_main(manager) -> dict:
    runs = {}
    for mode, kernel_name in (("auto", "packed_nesterov_step"),
                              ("legacy", "packed_softmax_grad")):
        os.environ["CS230_FUSED_STEP"] = mode
        status, wall, launches = _train(
            manager, _search(1000, 200, 5), "covertype", kernel_name, 1000)
        best = status["job_result"]["best_result"]
        runs[mode] = (status, launches)
        JOBS[f"main_{mode}"] = manager.job_id
        emit({"phase": f"main_{mode}", "wall_s": wall, "launches": launches,
              "best_params": best["search_params"],
              "best_mean_cv_score": best["mean_cv_score"]})
    os.environ["CS230_FUSED_STEP"] = "auto"
    a, b = _scores(runs["auto"][0]), _scores(runs["legacy"][0])
    worst = max(abs(a[k] - b[k]) for k in a)
    assert a.keys() == b.keys()
    assert worst <= 2e-3, f"auto vs legacy mean_cv_score differ by {worst}"
    assert (runs["auto"][0]["job_result"]["best_result"]["search_params"]
            == runs["legacy"][0]["job_result"]["best_result"]["search_params"])
    emit({"phase": "main_parity", "max_mean_cv_diff": worst, "best_params_equal": True})
    return {"packed_nesterov_step": runs["auto"][1]["packed_nesterov_step"],
            "packed_softmax_grad": runs["legacy"][1]["packed_softmax_grad"]}


def phase_main_profile(manager) -> dict:
    """bench.py's job cut to a few solver steps (max_iter 10), after phase
    main has warmed both CS230_FUSED_STEP modes: four untraced runs in
    turns (legacy, auto, auto, legacy) for the walls, then one run of each
    traced by torch.profiler: the device's busy share, device time by
    kernel (B2 under auto, B1 and the update's elementwise kernels under
    legacy) and the host's time by operation. Read beside main_auto /
    main_legacy, which ran in that order, auto from a cold start."""
    from torch.profiler import ProfilerActivity, profile

    kernel_of = {"legacy": "packed_softmax_grad", "auto": "packed_nesterov_step"}

    def run(mode):
        os.environ["CS230_FUSED_STEP"] = mode
        try:
            return _train(manager, _search(1000, 10, 5), "covertype", kernel_of[mode], 1000)
        finally:
            os.environ["CS230_FUSED_STEP"] = "auto"

    walls = {"legacy": [], "auto": []}
    for mode in ("legacy", "auto", "auto", "legacy"):
        walls[mode].append(run(mode)[1])
    out = {"walls_in_turns_s": walls}
    for mode in ("legacy", "auto"):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall, launches = run(mode)
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
        busy_us = sum(e.self_device_time_total for e in kernels)
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        top_host = sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]
        out[mode] = {"traced_wall_s": wall, "device_busy_ms": busy_us / 1e3,
                     "device_busy_share": busy_us / 1e6 / wall,
                     "device_ops": sum(e.count for e in kernels),
                     "launches": launches[kernel_of[mode]],
                     "top": [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3,
                              "count": e.count} for e in top],
                     "top_host": [{"name": e.key[:80], "ms": e.self_cpu_time_total / 1e3,
                                   "count": e.count} for e in top_host]}
    emit({"phase": "main_profile", "max_iter": 10, **out})
    return out


def phase_wide(manager) -> None:
    status, wall, launches = _train(
        manager, _search(4, 30, 3, C=(1e-3, 1e1), tol=(1e-4,)),
        "synthetic_4096x784x10", "masked_softmax_grad", 4)
    emit({"phase": "wide", "wall_s": wall, "launches": launches,
          "best_mean_cv_score": status["job_result"]["best_result"]["mean_cv_score"]})
    # one launch a solver step: 30 steps of one 16-lane dispatch
    assert launches["masked_softmax_grad"] == 30, launches


def phase_reference(manager) -> None:
    """A small search on the card vs the same search on the CPU through
    the kernels' plain versions."""
    from cs230_distributed_machine_learning_tpu_torch import MLTaskManager

    search = _search(16, 50, 5)
    gpu = manager.train(search, "synthetic_5000x54x7", {"random_state": 42}, timeout=900)
    os.environ["CS230_FORCE_PACKED"] = "1"  # the CPU takes the packed path too
    try:
        cpu = MLTaskManager(device="cpu").train(
            search, "synthetic_5000x54x7", {"random_state": 42}, timeout=900)
    finally:
        del os.environ["CS230_FORCE_PACKED"]
    g, c = _scores(gpu), _scores(cpu)
    worst = max(abs(g[k] - c[k]) for k in g)
    assert g.keys() == c.keys() and worst <= 2e-3, f"card vs CPU differ by {worst}"
    emit({"phase": "reference", "trials": len(g), "max_mean_cv_diff": worst,
          "best_params_equal": gpu["job_result"]["best_result"]["search_params"]
          == cpu["job_result"]["best_result"]["search_params"]})


def _forest(n_estimators: int, random_state: int = 42) -> dict:
    """``RandomForestClassifier(n_estimators=..., random_state=...)`` as a
    plain-estimator model_details payload (no search wrapper)."""
    return {"model_type": "RandomForestClassifier", "search_type": None,
            "base_estimator_params": {"n_estimators": n_estimators,
                                      "random_state": random_state}}


def stage_fraction(cfg, frac: float, rows: int = 0) -> tuple:
    """Stage a covertype fraction as its own CSV dataset, drawn and written
    as benchmarks/scaling_curve.py does (RandomState(0) permutation of the
    uncut table, encoded labels last, ``%.6g``); ``rows`` > 0 takes that
    many rows of the same permutation instead."""
    import numpy as np

    from cs230_distributed_machine_learning_tpu_torch.data.datasets import (
        DatasetCache,
        dataset_dir,
    )

    full = DatasetCache(root=cfg.storage.datasets_dir).get("covertype", "classification")
    X_full, y_full = np.asarray(full.X), np.asarray(full.y)
    n = rows or max(64, int(X_full.shape[0] * frac))
    idx = np.random.RandomState(0).permutation(X_full.shape[0])[:n]
    did = f"covertype_rows_{rows}" if rows else f"covertype_frac_{int(frac * 100)}"
    ddir = os.path.join(dataset_dir(did), "preprocessed")
    os.makedirs(ddir, exist_ok=True)
    csv = os.path.join(ddir, f"{did}_preprocessed.csv")
    if not os.path.exists(csv):
        header = ",".join([f"f{i}" for i in range(X_full.shape[1])] + ["target"])
        np.savetxt(csv, np.column_stack([X_full[idx], y_full[idx]]), delimiter=",",
                   header=header, comments="", fmt="%.6g")
    return did, n


def _forest_bucket(manager, dataset: str, n_estimators: int) -> tuple:
    """(kernel, cached TrialData, resolved static) of ``_forest``'s bucket on
    a staged dataset, as the trial engine resolves it."""
    from cs230_distributed_machine_learning_tpu_torch.models.registry import get_kernel

    kernel = get_kernel("RandomForestClassifier")
    data = manager._coordinator.cache.get(dataset, "classification")
    n, d = data.X.shape
    static_key, _ = kernel.canonicalize(_forest(n_estimators)["base_estimator_params"])
    static = kernel.resolve_static(kernel.static_from_key(static_key), n, d, data.n_classes)
    static["_n_classes"] = data.n_classes
    return kernel, data, static


def _rf_train(manager, phase: str, dataset: str, n_estimators: int) -> tuple:
    """One forest through the manager with B4's launch count zeroed just
    before and read just after; the count must be the arena's levels x
    trees x feature groups. Returns (launches, chunk plan)."""
    from cs230_distributed_machine_learning_tpu_torch.ops import cuda_hist as H

    H.reset_launches()
    t0 = time.perf_counter()
    status = manager.train(_forest(n_estimators), dataset, {"random_state": 42}, timeout=1200)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = H.LAUNCHES["level_histogram"]
    JOBS[phase] = manager.job_id
    assert status["job_status"] == "completed", status
    res = status["job_result"]
    assert not res["failed"] and len(res["results"]) == 1, res
    best = res["best_result"]
    assert all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in best["cv_scores"]), best

    kernel, data, static = _forest_bucket(manager, dataset, n_estimators)
    n, d = data.X.shape
    prepared = data._prepared_cache[(kernel.name, kernel.prepared_key(static))]
    plan = kernel.chunked_plan(static, n, d, data.n_classes, 6, prepared=prepared)
    groups = 2 if "xb_coarse" in prepared else 1
    expected = static["_levels"] * n_estimators * groups
    emit({"phase": phase, "dataset": dataset, "rows": n, "n_estimators": n_estimators,
          "wall_s": wall, "launches": launches, "expected_launches": expected,
          "chunks": plan and plan["n_chunks"], "levels": static["_levels"],
          "width": static["_W"], "n_bins": static["_n_bins"],
          "nb_sched": static.get("_nb_sched"), "wsched": static.get("_wsched"),
          "mean_cv_score": best["mean_cv_score"], "accuracy": best["accuracy"]})
    assert launches == expected, f"{phase}: {launches} B4 launches, expected {expected}"
    return launches, plan


def phase_rf_main(manager, cfg) -> int:
    """The scaling curve's RF job on the 10 % covertype fraction."""
    did, _ = stage_fraction(cfg, 0.1)
    launches, plan = _rf_train(manager, "rf_main", did, 100)
    assert plan and plan["n_chunks"] == 4, plan
    return launches


def phase_rf_profile(manager, dataset: str) -> None:
    """One tree of a job's forest (all 6 split lanes, one chunk step) under
    torch.profiler: its wall, the device's busy share of it, the kernels
    launched, and the device time by kernel, B4 among them."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from cs230_distributed_machine_learning_tpu_torch.ops.folds import build_split_plan

    kernel, data, static = _forest_bucket(manager, dataset, 100)
    dev = manager.device
    X = {k: torch.as_tensor(v, device=dev)
         for k, v in kernel.prepare_data(np.asarray(data.X), static).items()}
    y = torch.as_tensor(np.asarray(data.y), device=dev)
    plan = build_split_plan(np.asarray(data.y), task="classification", n_folds=5,
                            random_state=42)
    TW = torch.as_tensor(plan.train_w, device=dev)
    state = kernel.chunk_init(X, y, TW, {}, static)
    one_tree = {"n_chunks": 100, "trees_per_chunk": 1}
    kernel.chunk_step(X, y, TW, {}, static, 0, state, one_tree)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        kernel.chunk_step(X, y, TW, {}, static, 1, state, one_tree)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    emit({"phase": "rf_profile", "dataset": dataset, "lanes": int(TW.shape[0]),
          "levels": static["_levels"], "tree_wall_ms": 1e3 * wall,
          "device_busy_ms": busy_us / 1e3, "device_busy_share": busy_us / 1e6 / wall,
          "device_ops": sum(e.count for e in kernels),
          "top": [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3, "count": e.count}
                  for e in top]})


def phase_rf_full(manager) -> None:
    """The same job on the uncut covertype table."""
    _, plan = _rf_train(manager, "rf_full", "covertype", 100)
    assert plan and plan["n_chunks"] == 100, plan


def phase_rf_reference(manager) -> None:
    """Two small RF searches on the card and on the CPU (plain versions):
    the complete builder on iris and the chunked deep arena on 3,000
    synthetic rows. best_params_ equal, every mean_cv_score within 1e-6."""
    from cs230_distributed_machine_learning_tpu_torch import MLTaskManager
    from cs230_distributed_machine_learning_tpu_torch.ops import cuda_hist as H

    def grid(n_estimators, random_state):
        return {"model_type": "RandomForestClassifier", "search_type": "GridSearchCV",
                "base_estimator_params": {"random_state": random_state},
                "param_grid": {"n_estimators": n_estimators}, "cv_params": {"cv": 5}}

    cases = (("iris", grid([10, 20], 0), None),
             ("synthetic_3000x20x3", grid([3, 5], 1), "5e10"))
    for dataset, search, chunk_macs in cases:
        if chunk_macs:
            os.environ["CS230_TREE_CHUNK_MACS"] = chunk_macs
        try:
            H.reset_launches()
            t0 = time.perf_counter()
            gpu = manager.train(search, dataset, {"random_state": 42}, timeout=900)
            t_gpu = time.perf_counter() - t0
            launches = H.LAUNCHES["level_histogram"]
            cpu = MLTaskManager(device="cpu").train(search, dataset, {"random_state": 42},
                                                    timeout=900)
        finally:
            os.environ.pop("CS230_TREE_CHUNK_MACS", None)
        g, c = _scores(gpu), _scores(cpu)
        assert g.keys() == c.keys() and len(g) == 2, (g, c)
        worst = max(abs(g[k] - c[k]) for k in g)
        same = (gpu["job_result"]["best_result"]["search_params"]
                == cpu["job_result"]["best_result"]["search_params"])
        # one launch per tree level (all lanes at once), one feature group here
        trees = sum(search["param_grid"]["n_estimators"])
        _, _, static = _forest_bucket(manager, dataset, trees)
        per_tree = static["_levels"] if static.get("_deep") else static["_depth"]
        emit({"phase": "rf_reference", "dataset": dataset, "trials": len(g),
              "card_wall_s": t_gpu, "launches": launches, "launches_per_tree": launches / trees,
              "levels_per_tree": per_tree, "max_mean_cv_diff": worst,
              "best_params_equal": same, "scores": g})
        assert worst <= 1e-6 and same, f"rf_reference {dataset}: card vs CPU {worst}"
        assert launches == per_tree * trees, f"rf_reference {dataset}: {launches} launches"


def phase_kernels_mlp(dev) -> dict:
    """B5 against its plain version (bf16 operands) on the card, under Adam
    (the main path) and SGD: one step and an 8-step epoch checked
    (MLP_LIMITS), a full Adam epoch timed beside the plain version and the
    bound. No single PyTorch call computes an Adam epoch: library_ms is
    null."""
    from cs230_distributed_machine_learning_tpu_torch.ops import cuda_mlp as M

    gen = torch.Generator(device=dev).manual_seed(5)
    rows = {}
    for tag, (dims, bs, steps) in MLP_SHAPES.items():
        L = MLP_LANES
        kw = dict(dims=dims, act="relu", bs=bs, classification=True)
        X, Y, Wl, lr, alpha, params = mlp_inputs(gen, dev, dims, bs, steps, L)
        checks = {}
        for check, nb, lr_c in (("step", 1, lr),
                                ("epoch", MLP_CHECK_STEPS, torch.full_like(lr, MLP_EPOCH_LR))):
            part = (X[:nb * bs], Y[:nb * bs], Wl[:nb * bs].contiguous(), lr_c, alpha)
            for solver in ("adam", "sgd"):
                checks[(check, solver)] = mlp_check(M, part, params, L, solver,
                                                     dict(kw, n_batches=nb))
        emit({"phase": "kernels_mlp_check", "tag": tag,
              "checks": {f"{c}_{s}": v for (c, s), v in checks.items()}})
        for key, limits in MLP_LIMITS.items():
            for metric, limit in limits.items():
                got = checks[key][metric]
                assert got < limit, f"B5 {tag} {key}: {metric} {got} (limit {limit})"
        adam = checks[("epoch", "adam")]
        state = M.epoch_state(params, L, "adam")

        full = (X, Y, Wl, lr, alpha)
        ms = time_ms(lambda: M.epoch(*full, 0, state, n_batches=steps, **kw), reps=3, warmup=1)
        plain = time_ms(lambda: M.epoch_reference(*full, 0, state, n_batches=steps, **kw),
                        reps=3, warmup=1)
        flops = M.epoch_flops(dims, bs, steps, L)
        nbytes = M.epoch_bytes(dims, bs, steps, L)
        t_ops, t_bytes = flops / PEAK_BF16, nbytes / PEAK_BYTES
        rows[("mlp_epoch", tag)] = dict(
            shape=dict(dims=list(dims), batch=bs, steps=steps, lanes=L),
            max_abs_err=adam["param_abs"], max_rel_err=adam["param_rel"],
            checks={f"{c}_{s}": v for (c, s), v in checks.items()},
            ms=ms, plain_ms=plain, library_ms=None, bound_ms=1e3 * max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            design_floor_ms=1e3 * M.epoch_bytes(dims, bs, steps, L, every_step=True) / PEAK_BYTES,
            tflops=flops / (ms * 1e-3) / 1e12)
        del X, Y, Wl, state
        torch.cuda.empty_cache()
    emit({"phase": "kernels_mlp",
          "limits": {f"{c}_{s}": v for (c, s), v in MLP_LIMITS.items()},
          "rows": [{"kernel": k, "tag": t, **v} for (k, t), v in rows.items()]})
    return rows


#: BASELINE config 5's search space (benchmarks/measure_baseline.py)
CONFIG5_SPACE = {
    "hidden_layer_sizes": [[128], [256], [512], [256, 128]],
    "learning_rate_init": [1e-4, 3e-4, 1e-3, 3e-3, 1e-2],
    "alpha": [1e-5, 1e-4, 1e-3],
    "batch_size": [128, 256],
}


def _mlp_search(space, n_iter, max_iter, cv=5):
    """``RandomizedSearchCV(MLPClassifier(max_iter=..., random_state=0),
    space, n_iter, cv, random_state=0)`` as the model_details payload,
    hidden_layer_sizes as lists."""
    return {
        "model_type": "MLPClassifier",
        "search_type": "RandomizedSearchCV",
        "base_estimator_params": {"max_iter": max_iter, "random_state": 0},
        "param_distributions": space,
        "n_iter": n_iter,
        "random_state": 0,
        "cv_params": {"cv": cv},
    }


def _mlp_expected_launches(space, n_iter, epochs) -> tuple:
    """B5 launches the job must make: one an epoch for every chunk of at
    most 64 trials of every (architecture, batch size) bucket."""
    from cs230_distributed_machine_learning_tpu_torch.utils.sklearn_compat import (
        parameter_sampler,
    )

    buckets = {}
    for p in parameter_sampler(space, n_iter, random_state=0):
        key = (tuple(p["hidden_layer_sizes"]), p["batch_size"])
        buckets[key] = buckets.get(key, 0) + 1
    chunks = sum(-(-n // 64) for n in buckets.values())
    return epochs * chunks, {f"{k[0]}/{k[1]}": v for k, v in sorted(buckets.items())}


def phase_mlp_main(manager) -> int:
    """BASELINE config 5 through the manager, uncut: 100 trials, B5's
    launches zeroed before and read after."""
    from cs230_distributed_machine_learning_tpu_torch.ops import cuda_mlp as M

    dataset = "synthetic_60000x784x10"
    t0 = time.perf_counter()
    data = manager._coordinator.cache.get(dataset, "classification")
    assert data.X.shape == (60_000, 784) and data.n_classes == 10, data.X.shape
    emit({"phase": "mlp_data", "dataset": dataset, "seconds": time.perf_counter() - t0})
    expected, buckets = _mlp_expected_launches(CONFIG5_SPACE, 100, 30)
    M.reset_launches()
    t0 = time.perf_counter()
    status = manager.train(_mlp_search(CONFIG5_SPACE, 100, 30), dataset,
                           {"random_state": 42}, timeout=1200)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = M.LAUNCHES["mlp_epoch"]
    JOBS["mlp_main"] = manager.job_id
    assert status["job_status"] == "completed", status
    res = status["job_result"]
    assert not res["failed"], res["failed"][:1]
    assert len(res["results"]) == 100, len(res["results"])
    scores = [r["mean_cv_score"] for r in res["results"]]
    assert all(math.isfinite(s) and 0.0 <= s <= 1.0 for s in scores), scores[:5]
    best = res["best_result"]
    emit({"phase": "mlp_main", "wall_s": wall, "trials": len(scores), "launches": launches,
          "expected_launches": expected, "buckets": buckets,
          "best_params": best["search_params"], "best_mean_cv_score": best["mean_cv_score"],
          "min_mean_cv_score": min(scores)})
    assert launches == expected, f"mlp_main: {launches} B5 launches, expected {expected}"
    return launches


def phase_mlp_reference(manager) -> None:
    """A small MLP search on the card (B5, bf16) and on the CPU (the plain
    version, f32, forced onto the fused path): every mean_cv_score within
    MLP_SEARCH_TOL."""
    from cs230_distributed_machine_learning_tpu_torch import MLTaskManager
    from cs230_distributed_machine_learning_tpu_torch.ops import cuda_mlp as M

    space = {"hidden_layer_sizes": [[32], [64, 32]], "learning_rate_init": [1e-3, 1e-2],
             "alpha": [1e-4], "batch_size": [128]}
    search = _mlp_search(space, 4, 3)
    dataset = "synthetic_4096x64x5"
    M.reset_launches()
    t0 = time.perf_counter()
    gpu = manager.train(search, dataset, {"random_state": 42}, timeout=900)
    t_gpu = time.perf_counter() - t0
    launches = M.LAUNCHES["mlp_epoch"]
    os.environ["CS230_FORCE_PACKED"] = "1"
    try:
        cpu = MLTaskManager(device="cpu").train(search, dataset, {"random_state": 42},
                                                timeout=900)
    finally:
        del os.environ["CS230_FORCE_PACKED"]
    g, c = _scores(gpu), _scores(cpu)
    assert g.keys() == c.keys() and len(g) == 4, (g, c)
    worst = max(abs(g[k] - c[k]) for k in g)
    same = (gpu["job_result"]["best_result"]["search_params"]
            == cpu["job_result"]["best_result"]["search_params"])
    emit({"phase": "mlp_reference", "dataset": dataset, "trials": len(g),
          "card_wall_s": t_gpu, "launches": launches, "max_mean_cv_diff": worst,
          "best_params_equal": same, "scores": g, "cpu_scores": c})
    assert launches == 2 * 3, f"mlp_reference: {launches} B5 launches, expected 6"
    assert worst <= MLP_SEARCH_TOL, f"mlp_reference: card vs CPU {worst}"

#: wide_full: a full-size 784-feature LogReg search on config 5's table
WIDE_FULL_DATASET = "synthetic_60000x784x10"
WIDE_FULL_STEPS = 100
WIDE_FULL_TRIALS = 32
WIDE_FULL_TOL = 2e-3


def phase_wide_full(manager) -> int:
    """RandomizedSearchCV(LogisticRegression(max_iter=100), C ~
    loguniform(1e-3, 1e2), n_iter=32, cv=5) on the table mlp_main staged:
    dp * c = 7,850 picks the nesterov solver and dpp 896 the generic
    driver, whose one dispatch holds 32 x 6 lanes and launches B3 once a
    solver step (100). Then the same job under CS230_MASKED_GRAD=xla (the
    gradient as torch ops on the card, no kernel) as the check: every
    mean_cv_score within WIDE_FULL_TOL, best_params_ equal unless the top
    two scores are that close (then both are printed)."""
    from scipy.stats import loguniform

    from cs230_distributed_machine_learning_tpu_torch.ops import cuda_logreg as K

    search = {"model_type": "LogisticRegression", "search_type": "RandomizedSearchCV",
              "base_estimator_params": {"max_iter": WIDE_FULL_STEPS},
              "param_distributions": {"C": loguniform(1e-3, 1e2)},
              "n_iter": WIDE_FULL_TRIALS, "random_state": 0, "cv_params": {"cv": 5}}
    t0 = time.perf_counter()
    data = manager._coordinator.cache.get(WIDE_FULL_DATASET, "classification")
    staged = time.perf_counter() - t0  # a cache hit: mlp_main staged the table
    assert data.X.shape == (60_000, 784) and data.n_classes == 10, data.X.shape
    runs = {}
    for mode in ("auto", "xla"):
        os.environ["CS230_MASKED_GRAD"] = mode
        try:
            K.reset_launches()
            t0 = time.perf_counter()
            status = manager.train(search, WIDE_FULL_DATASET, {"random_state": 42},
                                   timeout=1200)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(K.LAUNCHES)
        finally:
            os.environ.pop("CS230_MASKED_GRAD", None)
        assert status["job_status"] == "completed", status
        res = status["job_result"]
        assert not res["failed"], res["failed"][:1]
        assert len(res["results"]) == WIDE_FULL_TRIALS, len(res["results"])
        scores = [r["mean_cv_score"] for r in res["results"]]
        assert all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in scores), scores[:5]
        runs[mode] = (status, wall, launches)
    a, b = _scores(runs["auto"][0]), _scores(runs["xla"][0])
    assert a.keys() == b.keys()
    worst = max(abs(a[k] - b[k]) for k in a)
    best = {m: runs[m][0]["job_result"]["best_result"] for m in runs}
    same = best["auto"]["search_params"] == best["xla"]["search_params"]
    top = sorted(b.values(), reverse=True)[:2]
    close = top[0] - top[1] <= WIDE_FULL_TOL
    emit({"phase": "wide_full", "dataset": WIDE_FULL_DATASET, "staging_s": staged,
          "trials": len(a), "wall_s": runs["auto"][1], "launches": runs["auto"][2],
          "xla_wall_s": runs["xla"][1], "xla_launches": runs["xla"][2],
          "max_mean_cv_diff": worst, "best_params_equal": same,
          "best_params": best["auto"]["search_params"],
          "best_mean_cv_score": best["auto"]["mean_cv_score"],
          "xla_top_two_within_tolerance": close,
          **({} if same else {"xla_best_params": best["xla"]["search_params"],
                               "xla_top_two": top})})
    assert runs["auto"][2]["masked_softmax_grad"] == WIDE_FULL_STEPS, runs["auto"][2]
    assert runs["xla"][2]["masked_softmax_grad"] == 0, runs["xla"][2]
    assert worst <= WIDE_FULL_TOL, f"wide_full: kernel vs xla mean_cv_score differ by {worst}"
    assert same or close, "wide_full: best_params_ differ"
    return runs["auto"][2]["masked_softmax_grad"]


KNN_GRID = {"n_neighbors": KNN_GRID_KS, "weights": ["uniform", "distance"]}
#: B6 against its plain version: distances within this share of
#: max(qsq + tsq) (the expansion's f32 rounding grows with the norms)
KNN_D2_TOL = 1e-5
KNN_SEARCH_TOL = {"classification": 2e-3, "regression": 1e-4}


def _knn_search(model_type: str, grid: dict, cv: int = 5) -> dict:
    """``GridSearchCV(<model_type>(), grid, cv=cv)`` as the model_details
    payload."""
    return {"model_type": model_type, "search_type": "GridSearchCV",
            "base_estimator_params": {}, "param_grid": grid, "cv_params": {"cv": cv}}


def knn_table(manager) -> tuple:
    """The KNN table on the card, staged through the manager's dataset
    cache: (TrialData, X, the job's 6 split masks, staging seconds)."""
    return _knn_table(manager._coordinator.cache, manager.device)


def _knn_compare(K, Q, X, W, k, exact: bool) -> dict:
    """B6 against its plain version asked for k + 1 neighbours. Distances
    within KNN_D2_TOL of max(qsq + tsq); index sets equal wherever the
    plain k-th and (k+1)-th distances are more than that apart (the others
    are counted); with ``exact`` (integer data: every distance exact)
    both outputs equal to the bit, order included."""
    got_d, got_i = K.knn_topk(Q, X, W, k)
    ref_d, ref_i = K.knn_topk_reference(Q, X, W, k + 1)
    torch.cuda.synchronize()
    scale = float((Q * Q).sum(1).max() + (X * X).sum(1).max())
    tol = KNN_D2_TOL * scale
    err = float((got_d - ref_d[..., :k]).abs().max())
    gap = ref_d[..., k] - ref_d[..., k - 1]
    clear = gap > tol
    same = (torch.sort(got_i, dim=-1).values == torch.sort(ref_i[..., :k], dim=-1).values).all(-1)
    out = dict(max_abs_err=err, max_rel_err=err / scale, d2_tol=tol,
               sets_checked=int(clear.sum()), sets_unresolved=int((~clear).sum()),
               sets_differ=int((clear & ~same).sum()))
    if exact:
        out["exact"] = bool(torch.equal(got_d, ref_d[..., :k])
                            and torch.equal(got_i, ref_i[..., :k]))
        assert out["exact"], f"knn_topk k={k}: integer case not exact {out}"
    assert err <= tol, f"knn_topk k={k}: d2 error {err} > {tol}"
    assert out["sets_differ"] == 0, f"knn_topk k={k}: neighbour sets differ {out}"
    return out


def _knn_small_cases(K, gen, dev) -> list:
    """Duplicated training rows (exact ties: the lowest index must win), a
    lane with fewer than k masked-in rows (empty slots (3.4e38, -1)), the
    largest k, shapes off the tile grid and features over several staged
    chunks. Integer data makes every distance exact."""
    def ints(*shape):
        return torch.randint(-3, 4, shape, generator=gen, device=dev).float()

    rows = []
    Xd = ints(700, 7)
    Xd[350:] = Xd[:350]  # every row twice
    Wd = (torch.rand(3, 700, generator=gen, device=dev) > 0.3).float()
    Wd[1] = 0.0
    Wd[1, torch.tensor([5, 400, 699], device=dev)] = 1.0  # 3 rows for k > 3
    Qd = ints(300, 7)
    for k in (5, 25, K.SHARED_LISTS_MAX_K, 300):
        rows.append(dict(case="ties_and_empty_slots", k=k,
                         **_knn_compare(K, Qd, Xd, Wd, k, exact=True)))
    d2, idx = K.knn_topk(Qd, Xd, Wd, 5)
    assert bool((idx[1, :, 3:] == -1).all()) and bool((d2[1, :, 3:] == K.INF).all())
    for nq, n, d, k in ((257, 2049, 6, 3), (130, 1000, 130, 7), (1, 129, 54, 25)):
        Q = torch.randn(nq, d, generator=gen, device=dev)
        X = torch.randn(n, d, generator=gen, device=dev)
        W = (torch.rand(2, n, generator=gen, device=dev) > 0.2).float()
        rows.append(dict(case=f"nq{nq}_n{n}_d{d}", k=k,
                         **_knn_compare(K, Q, X, W, k, exact=False)))
    return rows


def phase_kernels_knn(manager) -> dict:
    """B6 against its plain version on the card: at the launch shape of
    knn_main (queries: rows 0-4,095 of the staged table; the job's 6 split
    masks; k 5 and 25), then small cases. Times (median ms, CUDA events)
    of the kernel, the plain version, and the library: torch.cdist plus a
    masked torch.topk(largest=False), since no single PyTorch call
    computes the function."""
    from cs230_distributed_machine_learning_tpu_torch.ops import cuda_knn as K

    dev = manager.device
    data, X, W, staged = knn_table(manager)
    emit({"phase": "knn_data", "dataset": KNN_DATASET, "shape": list(data.X.shape),
          "seconds": staged})
    Q = X[:KNN_QUERIES].contiguous()
    L, n = W.shape
    nq, d = Q.shape
    rows = {}
    # the grid's k, then k 300: its lists live in device memory
    for k in KNN_GRID_KS + [KNN_DEVICE_LISTS_K]:
        check = _knn_compare(K, Q, X, W, k, exact=False)
        got, ref = K.knn_topk(Q, X, W, k), K.knn_topk_reference(Q, X, W, k)
        check["bit_equal"] = bool(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]))
        check["list_mode"] = K.knn_list_mode(k)
        check["digest"] = digest(*got)  # kernel_ab.py prints the same for its inputs
        del got, ref
        ms = time_ms(lambda: K.knn_topk(Q, X, W, k), reps=5, warmup=1)
        plain = time_ms(lambda: K.knn_topk_reference(Q, X, W, k), reps=3, warmup=1)

        def library():
            dist = torch.cdist(Q, X)
            return torch.topk(dist.masked_fill(W[:, None, :] <= 0, float("inf")), k,
                              dim=-1, largest=False)

        lib_ms = time_ms(library, reps=3, warmup=1)
        t_ops = K.knn_operations(L, nq, n, d) / PEAK_F32
        t_bytes = K.knn_bytes(L, nq, n, d, k) / PEAK_BYTES
        rows[("knn_topk", f"launch_k{k}")] = dict(
            shape=dict(lanes=L, queries=nq, rows=n, features=d, k=k), **check,
            ms=ms, plain_ms=plain, library_ms=lib_ms,
            library_note="torch.cdist + masked torch.topk: no single call computes it",
            bound_ms=1e3 * max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            plan=K.knn_plan(nq, n, L, k),
            design_floor_ms=1e3 * K.knn_design_operations(L, nq, n, d, k) / PEAK_F32,
            tflops=2.0 * nq * n * d * L / (ms * 1e-3) / 1e12)
        torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(7)
    small = _knn_small_cases(K, gen, dev)
    emit({"phase": "kernels_knn", "d2_tolerance": KNN_D2_TOL,
          "rows": [{"kernel": k, "tag": t, **v} for (k, t), v in rows.items()],
          "small": small})
    del X, W, Q
    torch.cuda.empty_cache()
    return rows


def _knn_bucket_plans(manager, model_type, dataset, grid) -> dict:
    """``chunked_plan`` of every (n_neighbors, weights) bucket of a grid, as
    the trial engine resolves it; None where the bucket runs whole."""
    from cs230_distributed_machine_learning_tpu_torch.models.registry import get_kernel

    kernel = get_kernel(model_type)
    data = manager._coordinator.cache.get(dataset, kernel.task)
    n, d = data.X.shape
    plans = {}
    for k in grid["n_neighbors"]:
        for w in grid["weights"]:
            static_key, _ = kernel.canonicalize({"n_neighbors": k, "weights": w})
            static = kernel.resolve_static(kernel.static_from_key(static_key), n, d,
                                           data.n_classes)
            plans[f"{k}/{w}"] = kernel.chunked_plan(static, n, d, data.n_classes, 6,
                                                    device=manager.device)
    return plans


def phase_knn_main(manager) -> int:
    """The slice's main path: GridSearchCV(KNeighborsClassifier(), KNN_GRID,
    cv=5) on the 200,000-row table through the manager, B6's launches
    zeroed before and read after; they must be chunked_plan's count (one a
    query chunk of every bucket: each bucket is one trial)."""
    from cs230_distributed_machine_learning_tpu_torch.ops import cuda_knn as K

    plans = _knn_bucket_plans(manager, "KNeighborsClassifier", KNN_DATASET, KNN_GRID)
    assert all(plans.values()), plans
    expected = sum(p["n_chunks"] for p in plans.values())
    K.reset_launches()
    t0 = time.perf_counter()
    status = manager.train(_knn_search("KNeighborsClassifier", KNN_GRID), KNN_DATASET,
                           {"random_state": 42}, timeout=1200)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.LAUNCHES["knn_topk"]
    JOBS["knn_main"] = manager.job_id
    assert status["job_status"] == "completed", status
    res = status["job_result"]
    assert not res["failed"], res["failed"][:1]
    assert len(res["results"]) == 4, len(res["results"])
    scores = [r["mean_cv_score"] for r in res["results"]]
    assert all(math.isfinite(s) and 0.0 <= s <= 1.0 for s in scores), scores
    best = res["best_result"]
    emit({"phase": "knn_main", "dataset": KNN_DATASET, "wall_s": wall, "trials": len(scores),
          "launches": launches, "expected_launches": expected, "plans": plans,
          "best_params": best["search_params"], "best_mean_cv_score": best["mean_cv_score"],
          "scores": _scores(status)})
    assert launches == expected, f"knn_main: {launches} B6 launches, expected {expected}"
    return launches


def phase_knn_reference(manager) -> None:
    """Small KNN searches (5,000 rows) on the card and on the CPU: a
    classifier grid (k 1, 5, 25 x both weights) and a regressor grid, once
    under CS230_FORCE_PACKED=1 (the card launches B6, the CPU runs its
    plain version) and once without (both take the generic path). Every
    mean_cv_score within KNN_SEARCH_TOL; best_params_ equal unless the
    CPU's top two trials are within the tolerance (then reported)."""
    from cs230_distributed_machine_learning_tpu_torch import MLTaskManager
    from cs230_distributed_machine_learning_tpu_torch.ops import cuda_knn as K

    dataset = "synthetic_5000x54x7"
    cases = (("KNeighborsClassifier", "classification",
              {"n_neighbors": [1, 5, 25], "weights": ["uniform", "distance"]}),
             ("KNeighborsRegressor", "regression",
              {"n_neighbors": [5, 25], "weights": ["uniform", "distance"]}))
    for forced in (True, False):
        for model_type, task, grid in cases:
            search = _knn_search(model_type, grid)
            if forced:
                os.environ["CS230_FORCE_PACKED"] = "1"
            try:
                K.reset_launches()
                t0 = time.perf_counter()
                gpu = manager.train(search, dataset, {"random_state": 42}, timeout=900)
                t_gpu = time.perf_counter() - t0
                launches = K.LAUNCHES["knn_topk"]
                t0 = time.perf_counter()
                cpu = MLTaskManager(device="cpu").train(search, dataset, {"random_state": 42},
                                                        timeout=900)
                t_cpu = time.perf_counter() - t0
            finally:
                os.environ.pop("CS230_FORCE_PACKED", None)
            assert not gpu["job_result"]["failed"] and not cpu["job_result"]["failed"]
            g, c = _scores(gpu), _scores(cpu)
            n_trials = len(grid["n_neighbors"]) * len(grid["weights"])
            assert g.keys() == c.keys() and len(g) == n_trials, (g, c)
            worst = max(abs(g[k] - c[k]) for k in g)
            tol = KNN_SEARCH_TOL[task]
            same = (gpu["job_result"]["best_result"]["search_params"]
                    == cpu["job_result"]["best_result"]["search_params"])
            top = sorted(c.values(), reverse=True)[:2]
            emit({"phase": "knn_reference", "model": model_type, "forced_kernel": forced,
                  "dataset": dataset, "trials": len(g), "card_wall_s": t_gpu,
                  "cpu_wall_s": t_cpu, "launches": launches, "max_mean_cv_diff": worst,
                  "tolerance": tol, "best_params_equal": same,
                  "cpu_top_two_within_tolerance": top[0] - top[1] <= tol, "scores": g,
                  "cpu_scores": c})
            assert worst <= tol, f"knn_reference {model_type}: card vs CPU {worst}"
            assert same or top[0] - top[1] <= tol, f"knn_reference {model_type}: best differs"
            # one launch a bucket when forced (no bucket is chunked at this size)
            assert launches == (n_trials if forced else 0), f"knn_reference: {launches}"


# ------------------------------------------------ tree families (slice 8)

#: card vs CPU bounds of the tree-family searches' mean_cv_score, by what
#: their fits sum. Integer-stat trees are exact. GaussianNB's f32 moment
#: products and the float-stat forests are summed in other orders, where a
#: close split call (ops/tree_checks.py: candidates that cut a node's rows
#: alike tie) may go either way, and a forest averages it over its trees.
#: A single float-stat tree takes such a flip whole, and boosting fits every
#: later stage around it: one flip moved a fold's r2 by 0.017 on the CPU
#: (port against reference), and a boosting grid's card and CPU runs by
#: 3.4e-3 (a 20-stage regressor at learning rate 0.3). gb_reference holds
#: single boosting stages split by split instead.
TREE_SEARCH_TOL = {"exact": 1e-6, "f32": 2e-3, "forest": 2e-3, "float_tree": 1e-2}
#: BASELINE config 4 (benchmarks/measure_baseline.py) as a model_details payload
GB_CONFIG4 = {"model_type": "GradientBoostingRegressor", "search_type": "GridSearchCV",
              "base_estimator_params": {"random_state": 0},
              "param_grid": {"n_estimators": [50, 100], "learning_rate": [0.05, 0.1]},
              "cv_params": {"cv": 5}}
#: the full-width boosting job: benchmarks/model_matrix.py's n_estimators
GB_MAIN = {"model_type": "GradientBoostingClassifier", "search_type": "GridSearchCV",
           "base_estimator_params": {"n_estimators": 50, "random_state": 0},
           "param_grid": {"learning_rate": [0.05, 0.1, 0.2, 0.5]}, "cv_params": {"cv": 5}}


def _grid_search(model_type: str, grid: dict, base: dict, cv: int = 5) -> dict:
    return {"model_type": model_type, "search_type": "GridSearchCV",
            "base_estimator_params": dict(base), "param_grid": grid, "cv_params": {"cv": cv}}


def _resolved(model_type: str, params: dict, n: int, d: int, c: int) -> tuple:
    """(kernel, the bucket's resolved static) as the trial engine resolves
    a trial's parameters."""
    from cs230_distributed_machine_learning_tpu_torch.models.registry import get_kernel

    kernel = get_kernel(model_type)
    static = kernel.resolve_static(kernel.static_from_key(kernel.canonicalize(params)[0]),
                                   n, d, c)
    static["_n_classes"] = c
    return kernel, static


def _buckets(search: dict):
    """Every trial's parameters (base estimator's plus the grid point)."""
    import itertools

    grid = search["param_grid"]
    for values in itertools.product(*grid.values()):
        yield {**search["base_estimator_params"], **dict(zip(grid, values))}


def _card_vs_cpu(manager, phase: str, search: dict, dataset: str, tol: float,
                 env=None, **extra) -> tuple:
    """One search on the card, every launch count zeroed just before and read
    just after, then on the CPU (plain versions). Every mean_cv_score within
    ``tol`` and best_params_ equal unless the CPU's top two trials are that
    close. Returns (the card's scores, every kernel's launches in the card's
    run)."""
    from cs230_distributed_machine_learning_tpu_torch import MLTaskManager

    os.environ.update(env or {})
    try:
        reset_all_launches()
        t0 = time.perf_counter()
        gpu = manager.train(search, dataset, {"random_state": 42}, timeout=900)
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
        kernel_launches = all_launches()
        t0 = time.perf_counter()
        cpu = MLTaskManager(device="cpu").train(search, dataset, {"random_state": 42},
                                                timeout=900)
        t_cpu = time.perf_counter() - t0
    finally:
        for k in env or {}:
            os.environ.pop(k, None)
    for status in (gpu, cpu):
        assert status["job_status"] == "completed", status
        assert not status["job_result"]["failed"], status["job_result"]["failed"][:1]
    g, c = _scores(gpu), _scores(cpu)
    assert g.keys() == c.keys() and len(g) == len(list(_buckets(search))), (g, c)
    assert all(math.isfinite(v) for v in g.values()), g
    worst = max(abs(g[k] - c[k]) for k in g)
    same = (gpu["job_result"]["best_result"]["search_params"]
            == cpu["job_result"]["best_result"]["search_params"])
    top = sorted(c.values(), reverse=True)[:2]
    close = len(top) == 2 and top[0] - top[1] <= tol
    emit({"phase": phase, "model": search["model_type"], "dataset": dataset, "trials": len(g),
          "card_wall_s": t_gpu, "cpu_wall_s": t_cpu,
          "launches": kernel_launches["level_histogram"], "kernel_launches": kernel_launches,
          "max_mean_cv_diff": worst, "tolerance": tol, "best_params_equal": same,
          "cpu_top_two_within_tolerance": close, "scores": g, "cpu_scores": c, **extra})
    assert worst <= tol, f"{phase} {search['model_type']}: card vs CPU {worst}"
    assert same or close, f"{phase} {search['model_type']}: best_params_ differ"
    return g, kernel_launches


def hist_float_rows(gen, dev, shapes=HIST_FLOAT_SHAPES) -> dict:
    """B4's float mode at the boosting levels (HIST_FLOAT_SHAPES): within
    HIST_FLOAT_TOL of the plain version; whether two launches on the same
    inputs agree to the bit (recorded, not asserted: the f32 atomics land in
    any order); the kernel's, the plain version's and one index_add_'s
    median ms and the bound (bytes, or the adds at the f32 rate)."""
    from cs230_distributed_machine_learning_tpu_torch.ops import cuda_hist as H

    rows = {}
    for tag, (L, n, d, n_bins, n_nodes, kk) in shapes.items():
        local, xb, SC = gb_hist_inputs(gen, dev, L, n, d, n_bins, n_nodes)
        got = H.level_histogram(local, xb, SC, n_nodes, n_bins)
        again = H.level_histogram(local, xb, SC, n_nodes, n_bins)
        ref = H.level_histogram_reference(local, xb, SC, n_nodes, n_bins)
        torch.cuda.synchronize()
        fabs, frel = errors(got, ref)
        stable = bool(torch.equal(got, again))
        apart = float((got - again).abs().max())
        del got, again, ref
        torch.cuda.empty_cache()
        assert frel < HIST_FLOAT_TOL, f"level_histogram {tag}: float stats {frel}"
        ms = time_ms(lambda: H.level_histogram(local, xb, SC, n_nodes, n_bins))
        plain = time_ms(lambda: H.level_histogram_reference(local, xb, SC, n_nodes, n_bins),
                        reps=3)
        lib_ms, adds = hist_library_ms(local, xb, SC, n_nodes, n_bins)
        nbytes = H.hist_bytes(L, n, d, kk, n_nodes, n_bins)
        t_bytes, t_ops = nbytes / PEAK_BYTES, adds / PEAK_F32
        del local, xb, SC
        torch.cuda.empty_cache()
        rows[("level_histogram", tag)] = dict(
            shape=dict(lanes=L, rows=n, features=d, bins=n_bins, nodes=n_nodes, stats=kk),
            ctas=H.grid_ctas(n, n_nodes, d, n_bins, kk, L), float_max_abs_err=fabs,
            float_max_rel_err=frel, float_bit_stable=stable, two_launches_max_abs_diff=apart,
            ms=ms, plain_ms=plain, library_ms=lib_ms, bound_ms=1e3 * max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")
    emit({"phase": "kernels_hist", "stats": "float", "float_tolerance": HIST_FLOAT_TOL,
          "rows": [{"kernel": k, "tag": t, **v} for (k, t), v in rows.items()]})
    return rows


def phase_gb_titanic(manager) -> int:
    """BASELINE config 4, uncut: the titanic builtin staged raw, preprocessed
    with examples/titanic_preprocess.yaml (as a dict), then the
    GradientBoostingRegressor grid on the card and on the CPU. Two unchunked
    buckets of 2 trials x 6 splits = 12 lanes: B4 launches once a tree
    level a stage, (50 + 100) x 3 = 450."""
    t0 = time.perf_counter()
    assert manager.download_data("titanic", "titanic", "builtin")["status"] == "success"
    pre = manager.preprocess("titanic", TITANIC_PREPROCESS)
    staged = time.perf_counter() - t0
    data = manager._coordinator.cache.get("titanic", "regression")
    n, d = data.X.shape
    assert pre["n_rows"] == n == 867 and d == 12, (pre, data.X.shape)
    expected = 0
    for params in _buckets(GB_CONFIG4):
        if params["learning_rate"] != GB_CONFIG4["param_grid"]["learning_rate"][0]:
            continue  # one bucket per n_estimators: learning_rate is traced
        kernel, static = _resolved("GradientBoostingRegressor", params, n, d, 0)
        assert kernel.chunked_plan(static, n, d, 0, 6) is None
        expected += params["n_estimators"] * static["_depth"]
    _, used = _card_vs_cpu(manager, "gb_titanic", GB_CONFIG4, "titanic",
                           TREE_SEARCH_TOL["float_tree"], staging_s=staged,
                           rows=n, features=d, expected_launches=expected)
    launches = used["level_histogram"]
    assert launches == expected == 450, f"gb_titanic: {launches} B4 launches, {expected}"
    return launches


def reference_gb_plan(task, n, d, c, stages, depth, n_bins, n_splits, chunk_macs=4e13):
    """The reference's boosting chunk plan, written out from its arithmetic
    (JAX models/trees.py:980-1005): (6 classifier | 10 regressor) x splits x
    the per-(trial, split) MACs (stages x class trees x rows x 2^(depth-1)
    nodes x 2 stat columns x features x bins) over 4e13 a chunk."""
    k_eff = c if (task == "classification" and c > 2) else 1
    macs = ((6.0 if task == "classification" else 10.0) * n_splits
            * stages * k_eff * n * 2 ** (depth - 1) * 2 * d * n_bins)
    n_chunks = math.ceil(macs / chunk_macs)
    if n_chunks <= 1:
        return None
    per = math.ceil(stages / n_chunks)
    return {"n_chunks": math.ceil(stages / per), "trees_per_chunk": per}


def phase_gb_main(manager) -> int:
    """GB_MAIN on the uncut covertype table, twice: the reference's plan (3
    chunks of 17 stages), one bucket of 4 trials x 6 splits x 7 class trees
    = 168 lanes a launch, B4 launched once a level a stage (50 x 3 = 150).
    Whether the second run gives the first's per-trial scores is recorded
    (the f32 atomics may order the adds anew)."""
    from cs230_distributed_machine_learning_tpu_torch.ops import cuda_hist as H

    data = manager._coordinator.cache.get("covertype", "classification")
    (n, d), c = data.X.shape, data.n_classes
    base = GB_MAIN["base_estimator_params"]
    kernel, static = _resolved("GradientBoostingClassifier", base, n, d, c)
    plan = kernel.chunked_plan(static, n, d, c, 6)
    ref = reference_gb_plan("classification", n, d, c, base["n_estimators"], static["_depth"],
                            static["_n_bins"], 6)
    assert plan == ref == {"n_chunks": 3, "trees_per_chunk": 17}, (plan, ref)
    expected = base["n_estimators"] * static["_depth"]
    runs = []
    for _ in range(2):
        H.reset_launches()
        t0 = time.perf_counter()
        status = manager.train(GB_MAIN, "covertype", {"random_state": 42}, timeout=900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = H.LAUNCHES["level_histogram"]
        JOBS["gb_main"] = manager.job_id
        assert status["job_status"] == "completed", status
        res = status["job_result"]
        assert not res["failed"] and len(res["results"]) == 4, res["failed"][:1]
        scores = _scores(status)
        assert all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in scores.values()), scores
        runs.append((wall, launches, scores, res["best_result"]["search_params"]))
    apart = max(abs(runs[0][2][k] - runs[1][2][k]) for k in runs[0][2])
    emit({"phase": "gb_main", "dataset": "covertype", "rows": n, "features": d, "classes": c,
          "plan": plan, "reference_plan": ref, "lanes": 4 * 6 * c,
          "wall_s": [r[0] for r in runs], "launches": [r[1] for r in runs],
          "expected_launches": expected, "scores": runs[0][2],
          "second_run_scores_equal": runs[0][2] == runs[1][2],
          "second_run_max_diff": apart, "best_params": runs[0][3],
          "second_run_best_params_equal": runs[0][3] == runs[1][3]})
    assert all(r[1] == expected for r in runs), f"gb_main: {[r[1] for r in runs]} launches"
    return runs[0][1]


def phase_gb_reference(manager, cfg) -> None:
    """Boosting on the card and on the CPU on a 3,000-row covertype draw:
    a classifier grid through _run_chunked (CS230_TREE_CHUNK_MACS lowered
    to 1e11: 3 chunks of 2 stages) and a regressor grid unchunked, both
    with subsample 0.8 among the trials; then one stage of each family on
    both devices from the same raw scores (``gb_stage_check``)."""
    did, n = stage_fraction(cfg, 0.0, rows=3000)
    grid = {"learning_rate": [0.1, 0.3], "subsample": [1.0, 0.8]}
    cases = (("GradientBoostingClassifier", "classification", 6, "1e11"),
             ("GradientBoostingRegressor", "regression", 20, None))
    for model_type, task, stages, chunk_macs in cases:
        search = _grid_search(model_type, grid, {"n_estimators": stages, "random_state": 0})
        data = manager._coordinator.cache.get(did, task)
        (rows, d), c = data.X.shape, data.n_classes
        env = {"CS230_TREE_CHUNK_MACS": chunk_macs} if chunk_macs else {}
        os.environ.update(env)
        try:
            kernel, static = _resolved(model_type, search["base_estimator_params"], rows, d, c)
            plan = kernel.chunked_plan(static, rows, d, c, 6)
        finally:
            for k in env:
                os.environ.pop(k, None)
        assert plan == ({"n_chunks": 3, "trees_per_chunk": 2} if chunk_macs else None), plan
        _, used = _card_vs_cpu(manager, "gb_reference", search, did,
                               TREE_SEARCH_TOL["float_tree"], env=env, plan=plan, rows=rows)
        launches = used["level_histogram"]
        assert launches == stages * static["_depth"], f"gb_reference: {launches} launches"
        gb_stage_check(manager, model_type, did, task, search["base_estimator_params"],
                       {"learning_rate": [0.3, 0.3], "subsample": [0.8, 1.0]})


def gb_stage_check(manager, model_type: str, dataset: str, task: str, params: dict,
                   hyper: dict) -> None:
    """One boosting stage (t = 2) on the card and on the CPU from the same
    raw scores F (two stages on the CPU from the prior), lanes = the first
    two CV splits with ``hyper``'s values: every split equal but at close
    calls (ops/tree_checks.py, the CPU tree as the reference), compared leaf
    values within 1e-5, and F' within 1e-5 where no call was close."""
    import numpy as np

    from cs230_distributed_machine_learning_tpu_torch.ops import cuda_hist as H
    from cs230_distributed_machine_learning_tpu_torch.ops.folds import build_split_plan
    from cs230_distributed_machine_learning_tpu_torch.ops.tree_checks import check_tree
    from cs230_distributed_machine_learning_tpu_torch.utils import prng

    data = manager._coordinator.cache.get(dataset, task)
    (n, d), c = data.X.shape, data.n_classes
    kernel, static = _resolved(model_type, params, n, d, c)
    plan = build_split_plan(np.asarray(data.y), task=task, n_folds=5, random_state=42)
    prepared = kernel.prepare_data(np.asarray(data.X), static)
    cpu, card = torch.device("cpu"), manager.device
    on = {}
    for dev in (cpu, card):
        on[dev] = dict(xb=torch.as_tensor(prepared["xb"], device=dev),
                       y=torch.as_tensor(np.asarray(data.y), device=dev),
                       w=torch.as_tensor(plan.train_w[1:3], device=dev),
                       hyper={k: torch.tensor(v, device=dev) for k, v in hyper.items()})
    a = on[cpu]
    F = kernel.chunk_init({"xb": a["xb"]}, a["y"], a["w"], a["hyper"], static)
    F = kernel._stages(a["xb"], a["y"], a["w"], a["hyper"], static, F, range(2))
    key = prng.fold_in(prng.PRNGKey(static["_seed"]), 2)
    trees = {}
    H.reset_launches()
    for dev in (cpu, card):
        b = on[dev]
        trees[dev] = kernel._stage(b["xb"], b["y"], b["w"], b["hyper"], static, F.to(dev),
                                   key.to(dev))
    torch.cuda.synchronize()
    launches = H.LAUNCHES["level_histogram"]
    sub_key, feat_key = prng.split(key).unbind(-2)
    S, C, keys = kernel._stage_stats(a["y"], kernel._subsample(sub_key, a["w"],
                                     a["hyper"]["subsample"]), F, static, feat_key)
    (F_cpu, t_cpu), (F_card, t_card) = trees[cpu], trees[card]
    close = 0
    for lane in range(S.shape[0]):
        close += check_tree(
            prepared["xb"], S[lane].numpy(), C[lane].numpy(),
            {k: v[lane].numpy() for k, v in t_cpu.items()},
            {k: v[lane].cpu().numpy() for k, v in t_card.items()},
            depth=static["_depth"], n_bins=static["_n_bins"], msl=static["_msl"],
            mf=static["_mf"] if static["_mf"] < d else None,
            key=keys[lane] if keys.dim() == 2 else keys)
    f_diff = float((F_card.cpu() - F_cpu).abs().max())
    emit({"phase": "gb_reference", "check": "one stage, card vs CPU", "model": model_type,
          "trees": int(S.shape[0]), "internal_nodes": int(S.shape[0]) * (2 ** static["_depth"] - 1),
          "close_calls": close, "F_max_abs_diff": f_diff, "launches": launches})
    assert launches == static["_depth"], f"gb_stage_check: {launches} launches"
    assert close or f_diff <= 1e-5, f"gb_stage_check {model_type}: F' {f_diff}"


def stage_regression(cfg, n: int = 3000, d: int = 8) -> str:
    """A regression table with a continuous target (2 x0 - x1^2 + sin 3 x2
    plus noise, from RandomState(0)), staged as a preprocessed CSV."""
    import numpy as np

    from cs230_distributed_machine_learning_tpu_torch.data.datasets import dataset_dir

    did = f"regression_{n}x{d}"
    ddir = os.path.join(dataset_dir(did), "preprocessed")
    os.makedirs(ddir, exist_ok=True)
    csv = os.path.join(ddir, f"{did}_preprocessed.csv")
    if not os.path.exists(csv):
        rng = np.random.RandomState(0)
        X = rng.randn(n, d)
        y = 2 * X[:, 0] - X[:, 1] ** 2 + np.sin(3 * X[:, 2]) + 0.3 * rng.randn(n)
        header = ",".join([f"f{i}" for i in range(d)] + ["target"])
        np.savetxt(csv, np.column_stack([X, y]), delimiter=",", header=header, comments="",
                   fmt="%.6g")
    return did


def phase_trees_reference(manager, cfg) -> None:
    """The other tree families and GaussianNB on the card and on the CPU:
    RandomForestRegressor at 33 and 64 trees (past the reference's 32-tree
    window of the forest mean), DecisionTreeClassifier and -Regressor in the
    deep arena (max_depth None on 3,000 rows) and at max_depth 4, and
    GaussianNB; mean_cv_score within TREE_SEARCH_TOL by what each sums, B4
    launched once a tree level (a feature group) per tree."""
    reg = stage_regression(cfg)
    cls = "synthetic_3000x20x3"
    cases = (("RandomForestRegressor", reg, "regression", {"n_estimators": [33, 64]},
              {"max_depth": 6, "random_state": 0}, "forest"),
             ("DecisionTreeClassifier", cls, "classification", {"max_depth": [None, 4]},
              {"random_state": 0}, "exact"),
             ("DecisionTreeRegressor", reg, "regression", {"max_depth": [None, 4]},
              {"random_state": 0}, "float_tree"),
             ("GaussianNB", cls, "classification", {"var_smoothing": [1e-9, 1e-3]}, {}, "f32"))
    for model_type, dataset, task, grid, base, kind in cases:
        search = _grid_search(model_type, grid, base)
        data = manager._coordinator.cache.get(dataset, task)
        (n, d), c = data.X.shape, data.n_classes
        expected = 0
        for params in _buckets(search) if model_type != "GaussianNB" else ():
            kernel, static = _resolved(model_type, params, n, d, c)
            groups = 2 if (static.get("_deep") and "xb_coarse" in kernel.prepare_data(
                data.X, static)) else 1
            per_tree = static["_levels"] if static.get("_deep") else static["_depth"]
            expected += int(params.get("n_estimators", 1)) * per_tree * groups
        _, used = _card_vs_cpu(manager, "trees_reference", search, dataset,
                               TREE_SEARCH_TOL[kind], expected_launches=expected,
                               stat_kind=kind)
        launches = used["level_histogram"]
        assert launches == expected, f"trees_reference {model_type}: {launches} launches"


# ------------------------------------------------- slice 9: scorers and SVMs

#: scored_main: bench.py's search with a probability scorer, cut to 256
#: trials so that its 256 x 6 lanes are one generic dispatch
SCORED_MAIN_TRIALS = 256
SCORED_MAIN_STEPS = 200
SCORED_MAIN_SCORER = "neg_log_loss"
#: kernel vs xla on scored_main: the bf16 residual bound of wide_full
SCORED_MAIN_TOL = 2e-3
#: card vs CPU limits of the scored searches (PERF.md section 2)
SCORED_TOL = {"LogisticRegression": 2e-3, "RandomForestClassifier": 1e-6,
              "DecisionTreeClassifier": 1e-6, "GaussianNB": 2e-3,
              "GradientBoostingClassifier": 1e-2, "MLPClassifier": MLP_SEARCH_TOL,
              "KNeighborsClassifier": 2e-3, "KNeighborsRegressor": 1e-4,
              "LinearRegression": 1e-4, "Ridge": 1e-4, "SVC": 2e-3, "SVR": 5e-3,
              "transform": 1e-5}
#: the kernels a scored job must never launch: the packed and fused paths
#: score by the default metric only (B1, B2, B5)
DEFAULT_ONLY_KERNELS = ("packed_softmax_grad", "packed_nesterov_step", "mlp_epoch")


def _kernel_modules():
    from cs230_distributed_machine_learning_tpu_torch.ops import (
        cuda_hist,
        cuda_knn,
        cuda_logreg,
        cuda_mlp,
    )

    return cuda_logreg, cuda_hist, cuda_mlp, cuda_knn


def reset_all_launches() -> None:
    for mod in _kernel_modules():
        mod.reset_launches()


def all_launches() -> dict:
    out = {}
    for mod in _kernel_modules():
        out.update(mod.LAUNCHES)
    return out


def _scored(search: dict, scoring) -> dict:
    return {**search, "cv_params": {**search.get("cv_params", {}), "scoring": scoring}}


def phase_scored_main(manager) -> int:
    """RandomizedSearchCV(LogisticRegression(max_iter=200), C ~
    loguniform(1e-3, 1e2), tol in {1e-4, 1e-3}, n_iter=256, cv=5,
    random_state=0, scoring="neg_log_loss") on covertype. A scored job
    leaves the packed path (as in the reference), so it runs the generic
    nesterov driver: one dispatch of 256 x 6 lanes, B3 launched once a
    solver step (200) at 1,536 lanes, and B1 / B2 never. Then the same job
    under CS230_MASKED_GRAD=xla (torch ops on the card): every
    mean_cv_score within SCORED_MAIN_TOL, best_params_ equal unless the
    top two are that close."""
    torch.cuda.empty_cache()
    search = _scored(_search(SCORED_MAIN_TRIALS, SCORED_MAIN_STEPS, 5), SCORED_MAIN_SCORER)
    runs = {}
    for mode in ("auto", "xla"):
        os.environ["CS230_MASKED_GRAD"] = mode
        try:
            reset_all_launches()
            t0 = time.perf_counter()
            status = manager.train(search, "covertype", {"random_state": 42}, timeout=1200)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = all_launches()
        finally:
            os.environ.pop("CS230_MASKED_GRAD", None)
        assert status["job_status"] == "completed", status
        res = status["job_result"]
        assert not res["failed"], res["failed"][:1]
        assert len(res["results"]) == SCORED_MAIN_TRIALS, len(res["results"])
        assert all(r["scoring"] == SCORED_MAIN_SCORER for r in res["results"])
        scores = [r["mean_cv_score"] for r in res["results"]]
        assert all(math.isfinite(v) and v <= 0.0 for v in scores), scores[:5]
        runs[mode] = (status, wall, launches)
        torch.cuda.empty_cache()
    a, b = _scores(runs["auto"][0]), _scores(runs["xla"][0])
    assert a.keys() == b.keys()
    worst = max(abs(a[k] - b[k]) for k in a)
    best = {m: runs[m][0]["job_result"]["best_result"] for m in runs}
    same = best["auto"]["search_params"] == best["xla"]["search_params"]
    top = sorted(b.values(), reverse=True)[:2]
    close = top[0] - top[1] <= SCORED_MAIN_TOL
    emit({"phase": "scored_main", "scoring": SCORED_MAIN_SCORER, "trials": len(a),
          "wall_s": runs["auto"][1], "launches": runs["auto"][2],
          "xla_wall_s": runs["xla"][1], "xla_launches": runs["xla"][2],
          "max_mean_cv_diff": worst, "tolerance": SCORED_MAIN_TOL, "best_params_equal": same,
          "best_params": best["auto"]["search_params"],
          "best_mean_cv_score": best["auto"]["mean_cv_score"],
          "xla_top_two_within_tolerance": close,
          **({} if same else {"xla_best_params": best["xla"]["search_params"],
                               "xla_top_two": top})})
    auto = runs["auto"][2]
    assert auto["masked_softmax_grad"] == SCORED_MAIN_STEPS, auto
    assert all(auto[k] == 0 for k in DEFAULT_ONLY_KERNELS), auto
    assert runs["xla"][2]["masked_softmax_grad"] == 0, runs["xla"][2]
    assert worst <= SCORED_MAIN_TOL, f"scored_main: kernel vs xla mean_cv_score differ by {worst}"
    assert same or close, "scored_main: best_params_ differ"
    return auto["masked_softmax_grad"]


#: the wide table: LogisticRegression takes the nesterov driver there (at
#: 54 features it takes Newton), so a scored search on it reaches B3
SCORED_WIDE = "synthetic_4096x784x10"
#: B6's gate is 150,000 training rows; the scored KNN searches force it,
#: as knn_reference does (the CPU then runs the kernel's plain version)
FORCE_B6 = {"CS230_FORCE_PACKED": "1"}
B4 = "level_histogram"


def _scoring_cases(cls, binary, reg):
    """(model, dataset, grid, base, scorers, the kernel the card's run must
    launch (None: none), env) of scoring_reference: a label, a margin and a
    probability scorer for each family with that output; KNN has labels
    only, SVC no probabilities, the regressors the regression scorers; the
    transformers take no scorer."""
    lr = {"C": [0.1, 1.0]}
    rf = ({"min_samples_leaf": [1, 5]}, {"n_estimators": 10, "max_depth": 6, "random_state": 0})
    dt = ({"max_depth": [4, 8]}, {"random_state": 0})
    nb = {"var_smoothing": [1e-9, 1e-3]}
    gb = ({"learning_rate": [0.1, 0.3]}, {"n_estimators": 10, "random_state": 0})
    mlp = ({"alpha": [1e-4, 1e-2]},
           {"hidden_layer_sizes": [32], "max_iter": 10, "random_state": 0})
    knn = {"n_neighbors": [5, 15]}
    return [
        ("LogisticRegression", cls, lr, {"max_iter": 50}, ("f1_macro", "neg_log_loss"), None, {}),
        ("LogisticRegression", binary, lr, {"max_iter": 50}, ("roc_auc",), None, {}),
        ("LogisticRegression", SCORED_WIDE, lr, {"max_iter": 30}, ("roc_auc_ovr",),
         "masked_softmax_grad", {}),
        ("RandomForestClassifier", "iris", *rf, ("roc_auc_ovr",), B4, {}),
        ("RandomForestClassifier", binary, *rf, ("balanced_accuracy", "average_precision"),
         B4, {}),
        ("DecisionTreeClassifier", cls, *dt, ("precision_weighted", "roc_auc_ovo"), B4, {}),
        ("DecisionTreeClassifier", binary, *dt, ("roc_auc",), B4, {}),
        ("GaussianNB", cls, nb, {}, ("recall_macro", "neg_log_loss"), None, {}),
        ("GaussianNB", binary, nb, {}, ("roc_auc",), None, {}),
        ("GradientBoostingClassifier", "iris", *gb, ("roc_auc_ovr",), B4, {}),
        ("GradientBoostingClassifier", binary, *gb, ("f1_micro", "average_precision"), B4, {}),
        ("MLPClassifier", cls, *mlp, ("precision_macro", "neg_log_loss"), None, {}),
        ("MLPClassifier", binary, *mlp, ("roc_auc",), None, {}),
        ("KNeighborsClassifier", cls, knn, {}, ("f1_weighted",), "knn_topk", FORCE_B6),
        ("KNeighborsRegressor", reg, knn, {}, ("neg_mean_absolute_error",), "knn_topk",
         FORCE_B6),
        ("LinearRegression", reg, {"fit_intercept": [True, False]}, {},
         ("neg_mean_squared_error",), None, {}),
        ("Ridge", reg, {"alpha": [0.1, 10.0]}, {}, ("explained_variance",), None, {}),
        ("SVC", "iris", {"C": [0.5, 2.0]}, {}, ("balanced_accuracy",), None, {}),
        ("SVC", binary, {"C": [0.5, 2.0]}, {}, ("roc_auc",), None, {}),
        ("SVR", reg, {"epsilon": [0.05, 0.2]}, {}, ("neg_root_mean_squared_error",), None, {}),
        ("PCA", cls, {"n_components": [2, 5]}, {}, (None,), None, {}),
        ("StandardScaler", cls, {"with_mean": [True, False]}, {}, (None,), None, {}),
        ("MinMaxScaler", cls, {"clip": [True, False]}, {}, (None,), None, {}),
        ("SimpleImputer", cls, {"strategy": ["mean", "median"]}, {}, (None,), None, {}),
        ("OneHotEncoder", "iris", {"max_categories": [4, 8]}, {}, (None,), None, {}),
    ]


def phase_scoring_reference(manager, cfg) -> None:
    """Small scored searches of every family on the card and on the CPU:
    a 5,000-row covertype-like table (54 features, 7 classes), a 2-class
    table for the binary margin scorers, iris (the forests' multiclass
    probability scorers: their CPU sides are slow at 5,000 rows), the
    wide table (B3) and the regression table; each within SCORED_TOL. The
    card's run of each launches exactly its family's kernel where the
    family has one and its gate is met (B3, B4, B6), and no other: never
    B1, B2 or B5, the default-scorer paths. Then the refusals, each
    failing its subtasks with the reason: a binary-only scorer on a
    multiclass target, a probability scorer on KNN and on SVC."""
    from cs230_distributed_machine_learning_tpu_torch.models.registry import get_kernel

    cls, binary, reg = "synthetic_5000x54x7", "synthetic_2000x20x2", stage_regression(cfg)
    searches = 0
    for model, dataset, grid, base, scorers, kernel, env in _scoring_cases(cls, binary, reg):
        task = get_kernel(model).task
        tol = SCORED_TOL["transform" if task == "transform" else model]
        for scoring in scorers:
            search = _grid_search(model, grid, base)
            if scoring is not None:
                search = _scored(search, scoring)
            _, used = _card_vs_cpu(manager, "scoring_reference", search, dataset, tol, env=env,
                                   scoring=scoring, expected_kernel=kernel)
            launched = {k for k, v in used.items() if v}
            assert launched == ({kernel} if kernel else set()), (model, scoring, used)
            searches += 1
    refusals = (("LogisticRegression", cls, "f1", "binary-only"),
                ("KNeighborsClassifier", cls, "neg_log_loss", "class probabilities"),
                ("SVC", "iris", "roc_auc_ovr", "class probabilities"))
    for model, dataset, scoring, reason in refusals:
        grid = {"n_neighbors": [5]} if model == "KNeighborsClassifier" else {"C": [1.0]}
        status = manager.train(_scored(_grid_search(model, grid, {}), scoring), dataset,
                               {"random_state": 42}, timeout=300)
        res = status["job_result"]
        assert status["job_status"] == "completed" and not res["results"], res
        assert res["failed"] and reason in res["failed"][0]["error"], res["failed"][:1]
    emit({"phase": "scoring_reference", "searches": searches,
          "refused": [f"{m} {s}" for m, _, s, _ in refusals]})


def reference_cv(model: str):
    """The JAX package's recorded mean CV of ``model`` on the 10 % covertype
    fraction (benchmarks/MODEL_MATRIX_MEASURED.json, ``cv_ours``), or None
    without the file: a score to read beside the port's, never a time."""
    path = os.path.join(ROOT, "benchmarks", "MODEL_MATRIX_MEASURED.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        rows = json.load(f)
    return next((r["cv_ours"] for r in rows if r.get("model") == model), None)


def phase_svc_matrix(manager, cfg) -> None:
    """SVC(), cv 5, on the 10 % covertype fraction (11,620 rows, rf_main
    staged it; benchmarks/model_matrix.py's draw): the exact dual, 21 OvO
    machines x 6 lanes in one ascent. Wall, the step at which the slowest
    lane stopped and mean_cv_score beside the reference's recorded one;
    then SVC card vs CPU on 3,000 rows of the same permutation, also on the
    exact path."""
    from cs230_distributed_machine_learning_tpu_torch.models import svm

    torch.cuda.empty_cache()
    did, n = stage_fraction(cfg, 0.1)
    payload = {"model_type": "SVC", "search_type": None, "base_estimator_params": {}}
    svm.reset_dual_stops()
    t0 = time.perf_counter()
    status = manager.train(payload, did, {"random_state": 42}, timeout=1200)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    JOBS["svc_matrix"] = manager.job_id
    res = status["job_result"]
    assert status["job_status"] == "completed" and not res["failed"], res.get("failed", [])[:1]
    best = res["best_result"]
    assert all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in best["cv_scores"]), best
    stops = dict(svm.DUAL_STOPS)
    emit({"phase": "svc_matrix", "dataset": did, "rows": n, "wall_s": wall,
          "dual_ascents": stops["ascents"], "slowest_lane_stop": stops["slowest_stop"],
          "step_cap": svm._pg_steps(), "mean_cv_score": best["mean_cv_score"],
          "reference_mean_cv_score": reference_cv("SVC"),
          "cv_scores": best["cv_scores"], "accuracy": best["accuracy"]})
    assert stops["ascents"] == 1  # one ascent: every machine of the 6 lanes
    cut, rows = stage_fraction(cfg, 0.0, rows=3000)
    _card_vs_cpu(manager, "svc_matrix", _grid_search("SVC", {"C": [1.0]}, {}), cut,
                 SCORED_TOL["SVC"], rows=rows)


#: svc_nystrom's card-vs-CPU cut: rows of the covertype permutation past
#: _MAX_N (so the Nyström path runs), the uncut fit's 4,096 landmarks (the
#: default at these rows would be 2,048), cv 2, and 100 of its 1,200 steps:
#: the CPU side's primal products grow with all three (at 300 steps the
#: CPU side took 78 s on the 8 host cores of an H100 machine)
NYSTROM_CUT = {"rows": 32_768, "cv": 2,
               "env": {"CS230_SVM_NYSTROM_M": "4096", "CS230_SVM_NYSTROM_STEPS": "100"}}


def phase_svc_nystrom(manager, cfg) -> None:
    """SVC() on the uncut covertype table as benchmarks/svc_quality.py runs
    it: past _MAX_N, the Nyström primal with 4,096 landmarks and 1,200
    Nesterov steps, one trial x 6 lanes. Then the same path card vs CPU
    (eigh of K_LL, K_LL^-1/2, the primal steps) at NYSTROM_CUT, within
    SCORED_TOL["SVC"]."""
    from cs230_distributed_machine_learning_tpu_torch.models import svm

    torch.cuda.empty_cache()
    payload = {"model_type": "SVC", "search_type": None, "base_estimator_params": {}}
    t0 = time.perf_counter()
    status = manager.train(payload, "covertype", {"random_state": 42}, timeout=1200)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = status["job_result"]
    assert status["job_status"] == "completed" and not res["failed"], res.get("failed", [])[:1]
    best = res["best_result"]
    assert all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in best["cv_scores"]), best
    emit({"phase": "svc_nystrom", "rows": 116_202, "landmarks": svm._nystrom_m(116_202),
          "steps": svm._nystrom_steps(), "wall_s": wall, "mean_cv_score": best["mean_cv_score"],
          "cv_scores": best["cv_scores"], "accuracy": best["accuracy"],
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    torch.cuda.empty_cache()
    cut, rows = stage_fraction(cfg, 0.0, rows=NYSTROM_CUT["rows"])
    assert rows > svm._MAX_N
    _card_vs_cpu(manager, "svc_nystrom", _grid_search("SVC", {"C": [1.0]}, {},
                                                       cv=NYSTROM_CUT["cv"]),
                 cut, SCORED_TOL["SVC"], env=NYSTROM_CUT["env"], rows=rows,
                 landmarks=int(NYSTROM_CUT["env"]["CS230_SVM_NYSTROM_M"]),
                 steps=int(NYSTROM_CUT["env"]["CS230_SVM_NYSTROM_STEPS"]))
    torch.cuda.empty_cache()

# --------------------------------------------------------- the winner artifact
# each job's winner refitted once on its holdout
# split's training rows, saved, loaded back as the artifact dict and
# predicted with on the card

#: the refitted winners: phase of the search -> (dataset, the kernel the
#: family's artifact path launches or None where it has none, the limit of
#: the holdout-score identity). The refit trains on split 0's rows, so its
#: accuracy on the eval rows is the winner's reported holdout accuracy:
#: exactly for the integer-stat forest; LogReg's search ran B2 and the
#: refit runs B3 (2e-3); the MLP's search ran B5 and the refit the generic
#: path (0.02, the fused-vs-generic bound); boosting's f32 atomics (1e-2);
#: KNN and SVC within their card-vs-CPU limits (2e-3)
ARTIFACT_JOBS = {
    "main_auto": ("covertype", "masked_softmax_grad", 2e-3),
    "rf_full": ("covertype", "level_histogram", 1e-6),
    "gb_main": ("covertype", "level_histogram", 1e-2),
    "knn_main": (KNN_DATASET, "knn_topk", 2e-3),
    "mlp_main": ("synthetic_60000x784x10", None, MLP_SEARCH_TOL),
    "svc_matrix": ("covertype_frac_10", None, 2e-3),
}
#: artifact_reference's cut of each refit: (table, rows, overrides of the
#: winner's parameters). Covertype cuts are rows of its permutation
#: (stage_fraction), scored on their holdout's eval rows. LogReg at 12,000
#: rows stays on the nesterov driver (B3 on the card); the forest at 5
#: trees, boosting at 20 stages and the MLP at 10 epochs keep the CPU sides
#: within seconds (at 50 stages and 30 epochs they took 12.9 and 17.1 s);
#: KNN under CS230_FORCE_PACKED=1, so the card takes B6 below 150,000 rows.
#: The MLP fits the first 4,096 rows of config 5's table and is scored on
#: all its 60,000: its card and CPU refits at a cut disagree on about half
#: the labels (Adam's sign flips compound, ROADMAP C), and over 820 eval
#: rows the rows' own spread of their accuracies' difference (~0.016)
#: would be the limit's size; over 60,000 rows it is ~0.003, and what is
#: left is the two refits' difference
ARTIFACT_CUTS = {
    "main_auto": ("covertype", 12_000, {}),
    "rf_full": ("covertype", 3000, {"n_estimators": 5}),
    "gb_main": ("covertype", 3000, {"n_estimators": 20}),
    "knn_main": ("covertype", 3000, {}),
    "mlp_main": ("synthetic_60000x784x10", 4096, {"max_iter": 10}),
    "svc_matrix": ("covertype", 3000, {}),
}


def _holdout(manager, dataset: str) -> tuple:
    """(TrialData, n_folds=0 plan, eval-row mask) of a staged dataset: the
    plan fit_artifact builds, whose split 0 is the search's holdout."""
    import numpy as np

    from cs230_distributed_machine_learning_tpu_torch.ops.folds import build_split_plan

    data = manager._coordinator.cache.get(dataset, "classification")
    plan = build_split_plan(np.asarray(data.y), task="classification", n_folds=0,
                            random_state=42)
    return data, plan, plan.eval_w[0] > 0


def phase_artifacts(manager) -> dict:
    """Each ARTIFACT_JOBS winner through the manager: every launch count
    zeroed, download_best_model (the refit on the card, the artifact
    written), load_best_model(as_sklearn=False), predict_with_artifact on
    the holdout's eval rows on the card, the counts read. The family's
    kernel must launch (B3 once a solver step, B4 once a level of every
    tree or stage, B6 once for the prediction), B1, B2 and B5 never, and
    nothing where the family's artifact path has no kernel; a second
    download returns the cached path; the holdout-score identity holds.
    Returns each winner's launch counts."""
    import numpy as np

    from cs230_distributed_machine_learning_tpu_torch.runtime.artifacts import (
        predict_with_artifact,
    )

    out = {}
    for tag, (dataset, kernel_name, tol) in ARTIFACT_JOBS.items():
        job = JOBS[tag]
        best = manager.best_result(job)
        data, plan, ev = _holdout(manager, dataset)
        reset_all_launches()
        t0 = time.perf_counter()
        path = manager.download_best_model(job)
        torch.cuda.synchronize()
        refit_s = time.perf_counter() - t0
        artifact = manager.load_best_model(job, as_sklearn=False)
        t0 = time.perf_counter()
        pred = predict_with_artifact(artifact, np.asarray(data.X)[ev])
        assert pred.device.type == "cuda", pred.device
        pred = pred.cpu().numpy()
        predict_s = time.perf_counter() - t0
        launches = all_launches()
        t0 = time.perf_counter()
        cached = manager.download_best_model(job) == path
        cached_s = time.perf_counter() - t0
        score = float(np.mean(pred == np.asarray(data.y)[ev]))
        diff = abs(score - best["accuracy"])
        static = artifact["static"]
        expected = {"main_auto": static.get("_iters"),
                    "gb_main": static.get("n_estimators", 100) * static.get("_depth", 0),
                    "knn_main": 1}.get(tag)
        if tag == "rf_full":
            kernel, _, rstatic = _forest_bucket(manager, dataset, 100)
            prepared = data._prepared_cache[(kernel.name, kernel.prepared_key(rstatic))]
            expected = rstatic["_levels"] * 100 * (2 if "xb_coarse" in prepared else 1)
        emit({"phase": "artifacts", "job": tag, "model": artifact["model_type"],
              "dataset": dataset, "parameters": best["search_params"], "refit_s": refit_s,
              "predict_s": predict_s, "cached_s": cached_s, "cached": cached,
              "artifact_mb": os.path.getsize(path) / 1e6, "eval_rows": int(ev.sum()),
              "holdout_accuracy": score, "best_result_accuracy": best["accuracy"],
              "holdout_diff": diff, "tolerance": tol, "kernel": kernel_name,
              "launches": {k: v for k, v in launches.items() if v},
              "expected_launches": expected})
        assert cached, f"artifacts {tag}: the second download refitted"
        assert not any(launches[k] for k in DEFAULT_ONLY_KERNELS), (tag, launches)
        if kernel_name is None:
            assert not any(launches.values()), (tag, launches)
        else:
            assert launches[kernel_name] == expected, (tag, launches, expected)
        assert diff <= tol, f"artifacts {tag}: holdout {score} vs {best['accuracy']}"
        out[tag] = launches
    return out


def phase_artifact_reference(manager, cfg) -> None:
    """The same refits at ARTIFACT_CUTS' cut, on the card and on the CPU
    (plain versions), each predicting its scored rows on its own device:
    the accuracies within the card-vs-CPU limits (SCORED_TOL)."""
    import numpy as np

    from cs230_distributed_machine_learning_tpu_torch.models.base import TrialData
    from cs230_distributed_machine_learning_tpu_torch.models.registry import get_kernel
    from cs230_distributed_machine_learning_tpu_torch.ops.folds import build_split_plan
    from cs230_distributed_machine_learning_tpu_torch.parallel.trial_map import fit_single
    from cs230_distributed_machine_learning_tpu_torch.runtime.artifacts import (
        predict_with_artifact,
    )

    for tag, (table, rows, overrides) in ARTIFACT_CUTS.items():
        best = manager.best_result(JOBS[tag])
        model = best["model_type"]
        params = {**best["parameters"], **overrides}
        if table == "covertype":
            did = stage_fraction(cfg, 0.0, rows=rows)[0]
            data, plan, ev = _holdout(manager, did)
            Xq, y = np.asarray(data.X)[ev], np.asarray(data.y)[ev]
        else:  # the table's first rows; scored on all of its rows
            did = f"{table}[:{rows}]"
            full = manager._coordinator.cache.get(table, "classification")
            Xq, y = np.asarray(full.X), np.asarray(full.y)
            data = TrialData(Xq[:rows], y[:rows], full.n_classes)
            plan = build_split_plan(data.y, task="classification", n_folds=0, random_state=42)
        env = {"CS230_FORCE_PACKED": "1"} if tag == "knn_main" else {}
        os.environ.update(env)
        try:
            res = {}
            for side, dev in (("card", manager.device), ("cpu", torch.device("cpu"))):
                reset_all_launches()
                t0 = time.perf_counter()
                fitted, static = fit_single(get_kernel(model), data, plan, params, device=dev)
                artifact = {"model_type": model, "parameters": params, "static": static,
                            "fitted_params": fitted}
                pred = predict_with_artifact(artifact, Xq, device=dev)
                pred = pred.cpu().numpy()
                res[side] = (pred, time.perf_counter() - t0, all_launches())
        finally:
            for k in env:
                os.environ.pop(k, None)
        acc = {k: float(np.mean(v[0] == y)) for k, v in res.items()}
        diff = abs(acc["card"] - acc["cpu"])
        emit({"phase": "artifact_reference", "job": tag, "model": model, "dataset": did,
              "overrides": overrides, "env": env, "scored_rows": len(y),
              "card_s": res["card"][1], "cpu_s": res["cpu"][1],
              "card_launches": {k: v for k, v in res["card"][2].items() if v},
              "accuracy": acc, "diff": diff, "labels_agree": float(
                  np.mean(res["card"][0] == res["cpu"][0])), "tolerance": SCORED_TOL[model]})
        assert diff <= SCORED_TOL[model], f"artifact_reference {tag}: {acc}"
        kernel_name = ARTIFACT_JOBS[tag][1]
        assert kernel_name is None or res["card"][2][kernel_name] > 0, (tag, res["card"][2])
        assert not any(res["card"][2][k] for k in DEFAULT_ONLY_KERNELS), (tag, res["card"][2])


def knn_predict_row(manager, k: int) -> dict:
    """B6 at the KNN winner's prediction: one lane (the holdout split's
    training rows), the 40,000 eval rows as queries, the winner's k.
    Checked as _knn_compare checks; the plain version timed once (its
    merge sorts [40,000, 4,096 + k] a training tile), the library
    (torch.cdist + a masked topk) in 10 blocks of 4,000 queries."""
    from cs230_distributed_machine_learning_tpu_torch.ops import cuda_knn as K

    data, X, _, _ = knn_table(manager)
    _, plan, ev = _holdout(manager, KNN_DATASET)
    W = torch.as_tensor(plan.train_w[:1], device=X.device).contiguous()
    Q = X[torch.as_tensor(ev, device=X.device)].contiguous()
    assert Q.shape[0] == KNN_PREDICT_QUERIES, Q.shape
    L, n = W.shape
    nq, d = Q.shape
    check = _knn_compare(K, Q, X, W, k, exact=False)
    ms = time_ms(lambda: K.knn_topk(Q, X, W, k), reps=5, warmup=1)
    plain = time_ms(lambda: K.knn_topk_reference(Q, X, W, k), reps=1, warmup=0)
    blk = KNN_PREDICT_QUERIES // 10

    def library():
        for i in range(0, nq, blk):
            dist = torch.cdist(Q[i:i + blk], X)
            torch.topk(dist.masked_fill(W[:, None, :] <= 0, float("inf")), k, dim=-1,
                       largest=False)

    lib_ms = time_ms(library, reps=1, warmup=1)
    t_ops = K.knn_operations(L, nq, n, d) / PEAK_F32
    t_bytes = K.knn_bytes(L, nq, n, d, k) / PEAK_BYTES
    del X, W, Q
    torch.cuda.empty_cache()
    return dict(shape=dict(lanes=L, queries=nq, rows=n, features=d, k=k), **check,
                ms=ms, plain_ms=plain, library_ms=lib_ms,
                library_note="torch.cdist + masked torch.topk in 10 query blocks: "
                             "no single call computes it",
                bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                plan=K.knn_plan(nq, n, L, k))


def artifact_kernel_rows(manager, dev, knn_k: int) -> dict:
    """The artifact path's kernels at its own shapes, against their plain
    versions, timed: B3 at one lane at the covertype refit, B4 at one lane
    at rf_full's widest level (integer stats) and at the boosting refit's
    root (7 class lanes, float stats), B6 at the KNN prediction."""
    from cs230_distributed_machine_learning_tpu_torch.ops import cuda_logreg as K

    gen = torch.Generator(device=dev).manual_seed(10)
    rows = {("masked_softmax_grad", "refit"): masked_kernel_row(
        K, gen, dev, "refit", *MASKED_REFIT_SHAPE, dp=MASKED_SCORED_DP)}
    rows.update(hist_kernel_rows(gen, dev, HIST_REFIT_SHAPES))
    rows.update(hist_float_rows(gen, dev, HIST_FLOAT_REFIT_SHAPES))
    rows[("knn_topk", "predict")] = knn_predict_row(manager, knn_k)
    emit({"phase": "kernels_artifact",
          "rows": [{"kernel": k, "tag": t, **v} for (k, t), v in rows.items()]})
    return rows


#: each kernel's artifact rows on the kernels line: (other_paths key, row
#: tag, the job whose winner's launches it counts)
ARTIFACT_PATHS = {
    "masked_softmax_grad": [("artifact", "refit", "main_auto")],
    "level_histogram": [("artifact", "refit_rf_widest", "rf_full"),
                        ("artifact_f32", "refit_gb_root", "gb_main")],
    "knn_topk": [("artifact", "predict", "knn_main")],
}
ROW_KEYS = ("shape", "max_abs_err", "max_rel_err", "float_max_rel_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "bound_unit", "library_ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from cs230_distributed_machine_learning_tpu_torch import MLTaskManager
    from cs230_distributed_machine_learning_tpu_torch.utils import config as cfg_mod

    # datasets and the journal live inside the checkout
    cfg = cfg_mod.FrameworkConfig.load()
    cfg.storage.root = os.path.join(ROOT, ".smoke_storage")
    cfg_mod.set_config(cfg)
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    env = phase_env()
    phase_build()
    rows = phase_kernels(dev)
    phase_data(cfg)
    manager = MLTaskManager()
    assert manager.device.type == "cuda"
    launches = phase_main(manager)
    phase_main_profile(manager)
    phase_wide(manager)
    phase_reference(manager)
    launches["level_histogram"] = phase_rf_main(manager, cfg)
    phase_rf_profile(manager, "covertype_frac_10")
    phase_rf_full(manager)
    phase_rf_profile(manager, "covertype")
    phase_rf_reference(manager)
    rows.update(phase_kernels_mlp(dev))
    launches["mlp_epoch"] = phase_mlp_main(manager)
    phase_mlp_reference(manager)
    launches["masked_softmax_grad"] = phase_wide_full(manager)
    rows.update(phase_kernels_knn(manager))
    launches["knn_topk"] = phase_knn_main(manager)
    phase_knn_reference(manager)
    # slice 8: the other tree families; B4's float mode on a search path
    seconds = {}
    t_phase = time.perf_counter()
    float_rows = hist_float_rows(torch.Generator(device=dev).manual_seed(8), dev)
    seconds["kernels_hist_float"] = time.perf_counter() - t_phase
    float_launches = {}
    for name, run in (("gb_titanic", lambda: phase_gb_titanic(manager)),
                      ("gb_main", lambda: phase_gb_main(manager)),
                      ("gb_reference", lambda: phase_gb_reference(manager, cfg)),
                      ("trees_reference", lambda: phase_trees_reference(manager, cfg))):
        t_phase = time.perf_counter()
        float_launches[name] = run()
        seconds[name] = time.perf_counter() - t_phase
    emit({"phase": "tree_families", "seconds": seconds, "total_s": sum(seconds.values())})
    # slice 9: every scorer, and the linear, SVM and transform families
    seconds = {}
    scored = {}
    for name, run in (("scored_main", lambda: phase_scored_main(manager)),
                      ("scoring_reference", lambda: phase_scoring_reference(manager, cfg)),
                      ("svc_matrix", lambda: phase_svc_matrix(manager, cfg)),
                      ("svc_nystrom", lambda: phase_svc_nystrom(manager, cfg))):
        t_phase = time.perf_counter()
        scored[name] = run()
        seconds[name] = time.perf_counter() - t_phase
    emit({"phase": "scorers_and_families", "seconds": seconds,
          "total_s": sum(seconds.values())})
    # the winner artifact: refitted, saved, loaded and predicted on the card
    seconds = {}
    t_phase = time.perf_counter()
    art_launches = phase_artifacts(manager)
    seconds["artifacts"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    phase_artifact_reference(manager, cfg)
    seconds["artifact_reference"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    knn_k = int(manager.best_result(JOBS["knn_main"])["parameters"]["n_neighbors"])
    art_rows = artifact_kernel_rows(manager, dev, knn_k)
    seconds["kernels_artifact"] = time.perf_counter() - t_phase
    emit({"phase": "artifact_path", "seconds": seconds, "total_s": sum(seconds.values())})

    jax_ops = "cs230_distributed_machine_learning_tpu/ops"
    table = {  # name: (row key, source, TPU kernel, shape note)
        "packed_softmax_grad": (8, "logreg", f"{jax_ops}/pallas_logreg.py:109",
                                "n_pad 116736, dpp 64, c 7, S 6, 8 blocks (1024 trials)"),
        "packed_nesterov_step": (8, "logreg", f"{jax_ops}/pallas_logreg.py:228",
                                 "n_pad 116736, dpp 64, c 7, S 6, 8 blocks (1024 trials)"),
        "masked_softmax_grad": ("wide_full", "logreg", f"{jax_ops}/pallas_logreg.py:372",
                                "n_pad 60160, dpp 896, cp 16, c 10, 192 lanes"),
        "level_histogram": ("rf_main_deep", "hist", f"{jax_ops}/pallas_hist.py:106",
                            "6 lanes, 11620 rows, 54 features, 24 bins, 128 nodes, 7 classes"),
        "mlp_epoch": ("784-512-10", "mlp", f"{jax_ops}/pallas_mlp.py:239",
                      "one epoch: 784-512-10, batch 256, 234 steps, 72 lanes, adam"),
        "knn_topk": ("launch_k5", "knn", f"{jax_ops}/pallas_knn.py:111",
                     "6 lanes, 4096 queries, 200000 rows, 54 features, k 5"),
    }
    kernels = []
    for name, (key, src, replaces, shape) in table.items():
        r = rows[(name, key)]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[src], "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "max_rel_err": r["max_rel_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"), "shape": shape,
            **{k: r[k] for k in ("float_max_abs_err", "float_max_rel_err", "bound_unit")
               if k in r},
        })
        if name == "masked_softmax_grad":  # B3 at scored_main's 1,536 lanes
            r = rows[(name, "scored_main")]
            kernels[-1]["other_paths"] = {"scored_main": {
                "launches": scored["scored_main"], "shape": "n_pad 116224, dpp 128, cp 16, c 7, "
                "1536 lanes (256 trials x 6 splits)",
                **{k: r[k] for k in ("max_abs_err", "max_rel_err", "ms", "plain_ms", "bound_ms",
                                     "bound_by", "bound_unit", "library_ms")}}}
        if name == "level_histogram":  # its float mode at the boosting levels
            kernels[-1]["float_modes"] = {
                tag: {k: float_rows[(name, tag)][k] for k in (
                    "ms", "bound_ms", "bound_by", "plain_ms", "library_ms",
                    "float_max_rel_err", "float_bit_stable")}
                for tag in HIST_FLOAT_SHAPES}
            kernels[-1]["float_launches"] = {k: float_launches[k]
                                             for k in ("gb_titanic", "gb_main")}
        for key, tag, job in ARTIFACT_PATHS.get(name, []):  # the winner artifact's path
            r = art_rows[(name, tag)]
            kernels[-1].setdefault("other_paths", {})[key] = {
                "launches": art_launches[job][name], "job": job,
                **{k: r[k] for k in ROW_KEYS if k in r}}
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    # not measured here: each kernel's ms as PERF.md stood before the
    # current kernels, at the same shapes, for reading beside the line below
    emit({"earlier_ms": EARLIER_MS, "source": EARLIER_MS_SOURCE})
    emit({"kernels": kernels})
    print(env["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
