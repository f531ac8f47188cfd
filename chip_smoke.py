"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; the first that fails ends the run with a
non-zero exit and no result line:

1. env      torch / CUDA versions and the card (name, power limit).
2. build    nvcc builds csrc/*.cu for sm_90a (seconds, ptxas report).
3. kernels  each CUDA kernel against its plain PyTorch version on the
            card at the main path's shapes (covertype: n_pad 116,736,
            dpp 64, 7 classes, 6 splits, 1 and 8 trial blocks; the
            784-feature lane kernel at dpp 896): max|err| / max|ref| <
            5e-3, the fused step's frozen columns exact, median ms by CUDA
            events beside the plain version's ms and the card's bound.
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
6. wide     a 784-feature, 10-class LogReg search (n = 4096) through the
            generic nesterov driver: the masked lane kernel must launch.
7. reference  a small search (5,000 rows) on the card and on the CPU
            (plain versions): every mean_cv_score within 2e-3.

Then the kernels line, the nvidia-smi line, and the result line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
when CUDA is unavailable. Needs one card.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "cs230_distributed_machine_learning_tpu_torch"
SOURCE = f"{PKG}/csrc/logreg.cu"
TOL = 5e-3
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 outside
# them, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# f32 operations per packed (row, column) element of the grouped softmax and
# residual: max, subtract, exp, sum, scale, subtract one-hot, weight
SOFTMAX_OPS = 7


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def errors(got, ref):
    """(max |got - ref|, that over max |ref|)."""
    got, ref = got.float(), ref.float()
    err = float((got - ref).abs().max())
    return err, err / (float(ref.abs().max()) + 1e-12)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of one call, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, mm_flops: float, f32_ops: float):
    """Least time for the work on this card: the largest of the bytes over
    HBM bandwidth, the bf16 products over the tensor cores' peak and the
    f32 operations over the f32 peak (the units run side by side, so
    their times overlap). Returns (ms, bound_by)."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(mm_flops / PEAK_BF16, f32_ops / PEAK_F32)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


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
    emit(info)
    return info


def phase_build() -> None:
    from cs230_distributed_machine_learning_tpu_torch.ops import cuda_build, cuda_logreg

    t0 = time.perf_counter()
    compiled = cuda_build.build()
    lib = cuda_logreg._lib()
    # the Python shared-memory gate must mirror the kernel's own layout
    for dpp, c, L in ((64, 7, 16), (64, 7, 32), (128, 7, 16), (64, 2, 32)):
        assert lib.logreg_packed_smem_bytes(dpp, c, L) == cuda_logreg.packed_smem_bytes(dpp, c, L)
    for dpp, cp in ((896, 16), (128, 128)):
        assert lib.logreg_masked_smem_bytes(dpp, cp) == cuda_logreg.masked_smem_bytes(dpp, cp)
    ptxas = [ln.strip() for ln in cuda_build.build_log("logreg").splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": sorted(compiled), "arch": "sm_90a", "ptxas": ptxas})


def _packed_inputs(gen, dev, n_pad, dpp, c, S, n_wb):
    Tw = 128
    B = S * Tw
    NB = c * B
    Ab = torch.randn(n_pad, dpp, generator=gen, device=dev).to(torch.bfloat16)
    y2 = torch.randint(0, c, (n_pad, 1), generator=gen, device=dev, dtype=torch.int32)
    WSP = (torch.rand(n_pad, S, generator=gen, device=dev) > 0.3).float()
    W = torch.randn(n_wb, dpp, NB, generator=gen, device=dev) * 0.05
    Wp = torch.randn(n_wb, dpp, NB, generator=gen, device=dev) * 0.05
    done = (torch.rand(n_wb, B, generator=gen, device=dev) > 0.7).float()
    step = 0.01 + torch.rand(n_wb, B, generator=gen, device=dev) * 0.1
    Cb = 0.1 + torch.rand(n_wb, B, generator=gen, device=dev)
    maxit = torch.where(torch.rand(n_wb, B, generator=gen, device=dev) > 0.5, 100.0, 2.0)
    pen = torch.ones(dpp, 1, device=dev)
    pen[-10:] = 0.0
    return Ab, W, Wp, y2, WSP, done, step, Cb, maxit, pen


def phase_kernels(dev) -> dict:
    """Every kernel vs its plain version at the main path's shapes."""
    from cs230_distributed_machine_learning_tpu_torch.ops import cuda_logreg as K

    gen = torch.Generator(device=dev).manual_seed(0)
    n_pad, dpp, c, S, t = 116_736, 64, 7, 6, 3.0
    rows = {}
    for n_wb in (1, 8):
        Ab, W, Wp, y2, WSP, done, step, Cb, maxit, pen = _packed_inputs(
            gen, dev, n_pad, dpp, c, S, n_wb)
        NB = W.shape[2]
        # B1: packed softmax-Gram gradient
        Wb = W.to(torch.bfloat16)
        got = K.packed_softmax_grad(Ab, Wb, y2, WSP, c=c, S=S)
        ref = K.packed_softmax_grad_reference(Ab, Wb, y2, WSP, c=c, S=S)
        abs1, err1 = errors(got, ref)
        assert err1 < TOL, f"packed_softmax_grad n_wb={n_wb}: {err1}"
        del got, ref
        ms1 = time_ms(lambda: K.packed_softmax_grad(Ab, Wb, y2, WSP, c=c, S=S))
        plain1 = time_ms(lambda: K.packed_softmax_grad_reference(Ab, Wb, y2, WSP, c=c, S=S), reps=3)
        mm = 4.0 * n_pad * dpp * NB * n_wb
        f32_ops = SOFTMAX_OPS * n_pad * NB * n_wb
        nbytes1 = Ab.numel() * 2 + Wb.numel() * 2 + y2.numel() * 4 + WSP.numel() * 4 + W.numel() * 4
        b1, by1 = bound_ms(nbytes1, mm, f32_ops)
        rows[("packed_softmax_grad", n_wb)] = dict(
            max_abs_err=abs1, max_rel_err=err1, ms=ms1, plain_ms=plain1,
            bound_ms=b1, bound_by=by1)

        # B2: fused Nesterov step, in place
        W_ref, Wp_ref, g_ref = K.packed_nesterov_step_reference(
            Ab, W, Wp, y2, WSP, t, done, step, Cb, maxit, pen, c=c, S=S, lam=1.0)
        Wk, Wpk = W.clone(), Wp.clone()
        K.packed_nesterov_step(Ab, Wk, Wpk, y2, WSP, t, done, step, Cb, maxit, pen,
                               c=c, S=S, lam=1.0)
        _, _, gk = K.packed_nesterov_step(Ab, W.clone(), Wp.clone(), y2, WSP, t, done,
                                          step, Cb, maxit, pen, c=c, S=S, lam=1.0)
        torch.cuda.synchronize()
        errs = [errors(Wk, W_ref), errors(Wpk, Wp_ref), errors(gk, g_ref)]
        abs2, err2 = max(e[0] for e in errs), max(e[1] for e in errs)
        assert err2 < TOL, f"packed_nesterov_step n_wb={n_wb}: {err2}"
        active = ((t < maxit) & (done == 0)).repeat(1, c)[:, None, :].expand_as(W)
        assert torch.equal(Wk[~active], W[~active]), "frozen W columns moved"
        assert torch.equal(Wpk[~active], Wp[~active]), "frozen Wp columns moved"
        del W_ref, Wp_ref
        ms2 = time_ms(lambda: K.packed_nesterov_step(
            Ab, Wk, Wpk, y2, WSP, t, done, step, Cb, maxit, pen, c=c, S=S, lam=1.0))
        plain2 = time_ms(lambda: K.packed_nesterov_step_reference(
            Ab, W, Wp, y2, WSP, t, done, step, Cb, maxit, pen, c=c, S=S, lam=1.0), reps=3)
        nbytes2 = (Ab.numel() * 2 + 4 * W.numel() * 4 + y2.numel() * 4 + WSP.numel() * 4
                   + 5 * done.numel() * 4 + pen.numel() * 4)
        b2, by2 = bound_ms(nbytes2, mm, f32_ops + 8 * W.numel())
        rows[("packed_nesterov_step", n_wb)] = dict(
            max_abs_err=abs2, max_rel_err=err2, ms=ms2, plain_ms=plain2,
            bound_ms=b2, bound_by=by2)
        del Ab, W, Wp, Wk, Wpk, Wb
        torch.cuda.empty_cache()

    # B3: masked lane kernel at the wide phase's shape (4 trials x 4 splits)
    n3, dpp3, cp, c3, lanes = 4096, 896, 16, 10, 16
    Ab = torch.randn(n3, dpp3, generator=gen, device=dev).to(torch.bfloat16)
    Wl = torch.randn(lanes, dpp3, cp, generator=gen, device=dev) * 0.02
    Wl[:, :, c3:] = 0
    Wl = Wl.to(torch.bfloat16)
    y2 = torch.randint(0, c3, (n3, 1), generator=gen, device=dev, dtype=torch.int32)
    wm = (torch.rand(n3, lanes, generator=gen, device=dev) > 0.3).float()
    got = K.masked_softmax_grad(Ab, Wl, y2, wm, c=c3)
    ref = K.masked_softmax_grad_reference(Ab, Wl, y2, wm, c=c3)
    abs3, err3 = errors(got, ref)
    assert err3 < TOL, f"masked_softmax_grad: {err3}"
    assert float(got[:, :, c3:].abs().max()) == 0.0, "padded classes not zero"
    ms3 = time_ms(lambda: K.masked_softmax_grad(Ab, Wl, y2, wm, c=c3))
    plain3 = time_ms(lambda: K.masked_softmax_grad_reference(Ab, Wl, y2, wm, c=c3))
    nbytes3 = Ab.numel() * 2 + Wl.numel() * 2 + y2.numel() * 4 + wm.numel() * 4 + got.numel() * 4
    # the products and the softmax over the c real classes; the padded
    # ones are the kernel's layout, not the function's work
    b3, by3 = bound_ms(nbytes3, 4.0 * n3 * dpp3 * c3 * lanes, SOFTMAX_OPS * n3 * c3 * lanes)
    rows[("masked_softmax_grad", lanes)] = dict(
        max_abs_err=abs3, max_rel_err=err3, ms=ms3, plain_ms=plain3,
        bound_ms=b3, bound_by=by3)
    emit({"phase": "kernels", "tolerance": TOL,
          "rows": [{"kernel": k, "n_wb_or_lanes": n, **v} for (k, n), v in rows.items()]})
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


def phase_wide(manager) -> int:
    status, wall, launches = _train(
        manager, _search(4, 30, 3, C=(1e-3, 1e1), tol=(1e-4,)),
        "synthetic_4096x784x10", "masked_softmax_grad", 4)
    emit({"phase": "wide", "wall_s": wall, "launches": launches,
          "best_mean_cv_score": status["job_result"]["best_result"]["mean_cv_score"]})
    return launches["masked_softmax_grad"]


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
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
    launches["masked_softmax_grad"] = phase_wide(manager)
    phase_reference(manager)

    replaces = {
        "packed_softmax_grad": "cs230_distributed_machine_learning_tpu/ops/pallas_logreg.py:109",
        "packed_nesterov_step": "cs230_distributed_machine_learning_tpu/ops/pallas_logreg.py:228",
        "masked_softmax_grad": "cs230_distributed_machine_learning_tpu/ops/pallas_logreg.py:372",
    }
    shapes = {"packed_softmax_grad": 8, "packed_nesterov_step": 8, "masked_softmax_grad": 16}
    kernels = []
    for name, key in shapes.items():
        r = rows[(name, key)]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces[name],
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "max_rel_err": r["max_rel_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None,
            "shape": ("n_pad 116736, dpp 64, c 7, S 6, 8 blocks (1024 trials)"
                      if key == 8 else "n_pad 4096, dpp 896, cp 16, 16 lanes"),
        })
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(env["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
