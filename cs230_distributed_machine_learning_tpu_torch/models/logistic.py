"""LogisticRegression kernel: multinomial softmax regression, batched over
(trial, split) lanes.

Port of the JAX package's ``models/logistic.py``. Objective (sklearn's):
``0.5 * ||W_coef||_F^2 + C * sum_i w_i * xent_i`` with the intercept
unpenalized; binary problems use the 2-column softmax with the penalty
doubled. Two solvers, chosen per bucket from the data shape
(``resolve_static``):

- **newton**: exact full-Hessian Newton steps with backtracking, f32, for
  small ``(d+1)*n_classes`` and ``n*(d+1)*n_classes``;
- **nesterov**: accelerated full-batch gradient descent with a
  power-iteration Lipschitz step, bf16 matmul operands with f32
  accumulation, for everything larger (covertype).

The generic drivers take the lane batch explicitly: weights are
``[T, S, dp, c]`` for T trials x S splits. Large nesterov buckets on the
card take the packed path instead (``build_batched_fn``): every trial's
weights packed class-major into 128-trial blocks, the whole fit driven by
one CUDA kernel launch per solver step (``ops/cuda_logreg.py``).

Valves (names and modes as in the JAX package):

- ``CS230_FUSED_STEP`` = ``auto`` | ``pallas`` | ``legacy``: the packed
  scan body. ``auto`` and ``pallas`` run the fused step kernel (the packed
  path is taken only where its gate passes, else the generic drivers
  run); ``legacy`` runs the gradient kernel plus separate tensor ops.
- ``CS230_MASKED_GRAD`` = ``auto`` | ``xla`` | ``pallas`` | ``legacy``: the
  generic nesterov driver's gradient. ``auto`` runs the masked lane kernel
  on the card for n >= 4096 when its gate passes and the fused-mask tensor
  formulation otherwise; ``xla`` always the fused-mask tensor formulation;
  ``pallas`` forces the kernel; ``legacy`` the pre-fusion formulation.
- ``CS230_FORCE_PACKED=1``: take the packed path whatever the device and
  n, and the masked lane kernel in the generic nesterov driver under
  ``auto`` (the kernels' plain versions on the CPU), for tests.

"pallas" names the kernel route in both packages.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from ..parallel.mesh import pad_to_multiple
from .base import ModelKernel, add_intercept, to_host

_NEWTON_STEPS = 25
_NESTEROV_STEPS = 400
# newton only when the flattened Hessian dim and the [n, dp*c] workspace fit
_NEWTON_MAX_DIM = 512
_NEWTON_MAX_WORKSPACE = 4_000_000


class LogisticRegressionKernel(ModelKernel):
    name = "LogisticRegression"
    task = "classification"
    hyper_defaults = {"C": 1.0, "max_iter": 100.0, "tol": 1e-4}
    static_defaults = {"fit_intercept": True, "penalty": "l2"}

    def trace_salt(self):
        """The resolved CS230_MASKED_GRAD and CS230_FUSED_STEP modes, the
        resolved CS230_STREAM mode (the streamed and single-shot drivers
        stage different forms) and the curves' valves."""
        from ..data.streaming import stream_mode
        from ..obs.curves import curves_salt

        return (_masked_grad_mode(), _fused_step_mode(), stream_mode(), curves_salt())

    def resolve_static(self, static: Dict[str, Any], n: int, d: int, n_classes: int):
        if static.get("penalty") not in ("l2", None, "none"):
            raise ValueError(
                f"LogisticRegression penalty={static.get('penalty')!r} not supported"
            )
        c = max(int(n_classes), 2)
        dp = d + (1 if static.get("fit_intercept", True) else 0)
        method = (
            "newton"
            if dp * c <= _NEWTON_MAX_DIM and n * dp * c <= _NEWTON_MAX_WORKSPACE
            else "nesterov"
        )
        return {**static, "_method": method}

    def bucket_static(self, static: Dict[str, Any], hypers) -> Dict[str, Any]:
        """Cap the solver's step count at the bucket's largest max_iter, so
        masked-out iterations are not executed at all."""
        cap = _NEWTON_STEPS if static["_method"] == "newton" else _NESTEROV_STEPS
        max_iters = [int(h.get("max_iter", 100)) for h in hypers] or [cap]
        return {**static, "_iters": max(1, min(cap, max(max_iters)))}

    # ---- out-of-core row-block streaming (data/streaming.py) -------------

    def stream_applicable(self, static: Dict[str, Any], n: int, d: int) -> bool:
        """Only the nesterov driver accumulates across row blocks: its
        gradient and power iteration are row sums. Newton wants its whole
        workspace resident, and its n threshold keeps it small anyway."""
        return static.get("_method") == "nesterov"

    def stream_form(self, X_np, static: Dict[str, Any]):
        """The host array blocks are sliced from, and a salt naming the
        form in the block keys."""
        return np.asarray(X_np, np.float32), ("raw", "f32")

    def stream_scores(self, streamer, y_pad, TW, EW, hyper_batch, static, n):
        """Block-accumulated nesterov over a RowBlockStreamer: 31
        power-iteration passes, one pass a solver step (with the
        host-visible early exit) and one eval pass; ``[T, S]`` accuracies
        as numpy. Pad rows carry zero weight, so every block sum is the
        single-shot value up to f32 summation order."""
        return _stream_nesterov_scores(streamer, y_pad, TW, EW, hyper_batch, static, n)

    def memory_estimate_mb(self, n, d, static):
        """Per-(trial, split) working set of the generic drivers: newton
        holds the [n, dp*c] Hessian factors, nesterov a few [n, c] tensors
        plus its lane's bf16 residual columns in the masked lane kernel's
        scratch (R^T, classes padded to 16)."""
        c = max(int(static.get("_n_classes", 2)), 2)
        if static.get("_method") == "newton":
            return max(1.0, 4.0 * 4.0 * n * (d + 1) * c / 1e6)
        return max(1.0, (6.0 * 4.0 * n * c + 2.0 * n * pad_to_multiple(c, 16)) / 1e6)

    # ---- lane-batched outputs of fitted weights W [..., dp, c] -----------

    def _logits(self, W, X, static):
        """f32 logits ``[..., n, c]`` of every lane, as the reference's
        ``A @ params``."""
        A = add_intercept(X, bool(static.get("fit_intercept", True)))
        return torch.einsum("nd,...dc->...nc", A, W)

    def predict(self, W, X, static):
        return self._logits(W, X, static).argmax(dim=-1)

    def predict_margin(self, W, X, static):
        """Binary margin: logit(class 1) - logit(class 0)."""
        Z = self._logits(W, X, static)
        return Z[..., 1] - Z[..., 0]

    def predict_proba(self, W, X, static):
        """Softmax class probabilities."""
        return torch.softmax(self._logits(W, X, static), dim=-1)

    # ---- generic drivers: explicit (trial, split) lane batch -------------

    def fit(self, X, y, w, hyper: Dict[str, Any], static: Dict[str, Any]):
        """Weights ``[T, S, dp, c]`` f32 of T trials (hypers ``[T]``) on S
        split masks ``w [S, n]``, by the bucket's solver. The winner's refit
        (one trial, one split) on the card takes kernel B3 at one lane
        wherever the nesterov driver would take it in a search."""
        return self._fit(X, y, w, hyper, static, trace=False)[0]

    def _fit(self, X, y, w, hyper, static, trace: bool):
        """(W ``[T, S, dp, c]``, the grad-norm trace or None, solver steps)."""
        n_classes = int(static["_n_classes"])
        c = max(n_classes, 2)
        fit_intercept = bool(static.get("fit_intercept", True))
        use_penalty = static.get("penalty") in ("l2",)
        A = add_intercept(X, fit_intercept)  # [n, dp]
        dp = A.shape[1]
        Y = _onehot(y, c)
        C = hyper["C"].float()
        max_iter = hyper["max_iter"].float()
        tol = hyper["tol"].float()
        T, S = C.shape[0], w.shape[0]
        lam = (1.0 if use_penalty else 0.0) * (2.0 if n_classes == 2 else 1.0)
        # intercept row is unpenalized (sklearn semantics)
        pen_mask = A.new_ones((dp, c))
        if fit_intercept:
            pen_mask[-1, :] = 0.0
        W0 = A.new_zeros((T, S, dp, c))
        w = w.float()

        mode = _masked_grad_mode()
        if static["_method"] == "newton":
            steps = int(static.get("_iters", _NEWTON_STEPS))
            W, tr = _newton(A, Y, w, W0, C, lam, pen_mask, max_iter, tol, steps,
                            fused=(mode != "legacy"), trace=trace)
        else:
            steps = int(static.get("_iters", _NESTEROV_STEPS))
            grad_fn = _make_masked_grad_fn(A, Y, y, w, C, lam, pen_mask, mode)
            W, tr = _nesterov(A, w, W0, grad_fn, C, lam, max_iter, tol, steps,
                              trace=trace)
        return W, tr, steps

    def batched_scores(self, X, y, TW, EW, hyper, static):
        from ..obs.curves import curves_enabled, trace_stride

        trace = curves_enabled()
        W, tr, steps = self._fit(X, y, TW, hyper, static, trace)
        out = dict(self.evaluate(W, X, y, EW.float()[None], static))  # [T, S]
        if trace:
            T, S = W.shape[:2]
            out["curve_gmax"] = tr.permute(1, 2, 0).contiguous()  # [T, S, P']
            out["curve_stride"] = W.new_full((T, S), float(trace_stride(steps)))
            out["curve_steps"] = W.new_full((T, S), float(steps))
        return out

    # ---- the artifact: the JAX layout is one lane's W [dp, c] ------------

    def artifact_params(self, params, lane: int = 0):
        return to_host(params.reshape(-1, *params.shape[-2:])[lane])

    def params_from_artifact(self, np_params, device):
        from ..ops.cuda_logreg import weights_from_jax

        return weights_from_jax(np_params, device)

    # ---- packed batched path (ops/cuda_logreg.py) ------------------------
    #
    # Large-n nesterov buckets on the card bypass the generic drivers: all
    # trials' weights are packed class-major into one tensor per 128-trial
    # block and each solver step is one kernel launch over every trial and
    # split; the probabilities never reach device memory.

    #: trials per packed weight block; the engine rounds chunks to it
    batched_trial_multiple = 128
    batched_chunk_cap = 1024

    def batched_applicable(self, static: Dict[str, Any], n: int, d: int,
                           device: torch.device) -> bool:
        if static.get("_method") != "nesterov":
            return False
        dpp = pad_to_multiple(d + 2, 64)  # + intercept, rounded
        if dpp > 512:
            return False
        from ..ops.cuda_logreg import fused_step_applicable

        geo = _packed_geometry(static, n, d, static.get("_n_classes", 2), 1)
        if not fused_step_applicable(geo["dpp"], geo["c"]):
            return False  # no lane tile fits one CTA: the generic drivers
        if _force_packed():
            return True
        return device.type == "cuda" and n >= 4096

    def batched_staged_extras(self, static, n, d, n_classes, n_splits,
                              fold_signature=None, *, device: torch.device):
        """Dispatch-invariant inputs of the packed path, staged by the
        trial engine in the stage cache (data/stage_cache.py) and merged
        into each dispatch's ``hyper`` under these names:

        - ``_logreg_ab``: the padded bf16 design matrix (B1/B2's operand);
        - ``_logreg_lam_max``: the per-split Lipschitz power iteration,
          keyed by the fold plan's signature.

        Returns ``{name: (subkey | None, make)}``; ``make(ctx)`` takes
        ``{"X", "y", "TW", "EW"}`` device tensors. A ``None`` subkey means
        made once a bucket, not cached (no fold signature to key on).
        Empty under ``CS230_FUSED_STEP=legacy``, which derives everything
        inline, as the JAX package's rollback path does."""
        if _fused_step_mode() == "legacy" or not self.batched_applicable(static, n, d, device):
            return {}
        geo = _packed_geometry(static, n, d, n_classes, n_splits)
        fit_intercept, dpp, n_pad = geo["fit_intercept"], geo["dpp"], geo["n_pad"]

        def make_ab(ctx):
            return _padded_design(ctx["X"], fit_intercept, dpp, n_pad).to(torch.bfloat16)

        def make_lam_max(ctx):
            TWp = torch.nn.functional.pad(ctx["TW"].float(), (0, n_pad - n))
            return _lam_max(_padded_design(ctx["X"], fit_intercept, dpp, n_pad), TWp)

        return {
            "_logreg_ab": (("ab", fit_intercept, dpp, n_pad), make_ab),
            "_logreg_lam_max": (
                None if fold_signature is None
                else ("lam_max", fold_signature, fit_intercept, dpp, n_pad),
                make_lam_max),
        }

    def build_batched_fn(self, static, n, d, n_classes, n_splits, chunk,
                         device: torch.device):
        """Returns fn(X, y, TW, EW, hyper) -> {"score": [chunk, n_splits]}
        (plus the curve leaves), or None when the packed path does not
        apply. One call = the whole fit plus eval for ``chunk`` trials.
        ``hyper`` may carry ``batched_staged_extras``' forms (the engine
        merges them in); when absent — direct calls, ``legacy`` — they are
        derived inline, to the same bits."""
        if not self.batched_applicable(static, n, d, device):
            return None
        Tw = self.batched_trial_multiple
        if chunk % Tw:
            return None

        from ..obs.curves import curves_enabled, trace_stride
        from ..ops.cuda_logreg import packed_nesterov_step, packed_softmax_grad

        geo = _packed_geometry(static, n, d, n_classes, n_splits)
        c, S = geo["c"], geo["S"]
        fit_intercept = geo["fit_intercept"]
        lam = geo["lam"]
        steps = int(static.get("_iters", _NESTEROV_STEPS))
        n_wb = chunk // Tw
        Bblk = S * Tw
        NB = c * Bblk
        dp, dpp = geo["dp"], geo["dpp"]
        rc = geo["rc"]  # eval row-chunk
        n_pad = geo["n_pad"]  # multiple of rc
        # batched_applicable has passed the fused step's gate; legacy keeps
        # the gradient kernel + tensor-op body
        use_fused = _fused_step_mode() != "legacy"
        capture = curves_enabled()
        tr_stride = trace_stride(steps) if capture else 1
        tr_used = -(-steps // tr_stride) if capture else 0

        # static column maps: block col j -> (split, trial-in-block)
        j = np.arange(Bblk)
        split_of = torch.as_tensor(j // Tw, device=device)
        trial_map = torch.as_tensor(
            (np.arange(n_wb)[:, None] * Tw + (j % Tw)[None, :]).clip(max=chunk - 1),
            device=device,
        )
        # rows: penalty applies to real feature rows, never the intercept/pad
        pen = np.zeros((dpp, 1), np.float32)
        pen[:dp, 0] = 1.0
        if fit_intercept:
            pen[dp - 1, 0] = 0.0
        pen_col = torch.as_tensor(pen, device=device)
        pen_row = pen_col.reshape(1, dpp, 1)

        def fn(X, y, TW, EW, hyper):
            y_pad = torch.nn.functional.pad(y.to(torch.int32), (0, n_pad - n))
            y2 = y_pad[:, None].contiguous()
            TWp = torch.nn.functional.pad(TW.float(), (0, n_pad - n))
            EWp = torch.nn.functional.pad(EW.float(), (0, n_pad - n))
            WSP = TWp.T.contiguous()  # [n_pad, S]
            Ab, lam_max = hyper.get("_logreg_ab"), hyper.get("_logreg_lam_max")
            if Ab is None or lam_max is None:
                A = _padded_design(X, fit_intercept, dpp, n_pad)  # [n_pad, dpp] f32
                Ab = A.to(torch.bfloat16) if Ab is None else Ab
                # Lipschitz bound per split: L <= 0.5*C*lam_max(A' diag(w) A) + lam
                lam_max = _lam_max(A, TWp) if lam_max is None else lam_max

            Cb = hyper["C"].float()[trial_map]  # [n_wb, Bblk]
            maxit_b = hyper["max_iter"].float()[trial_map]
            tol_b = hyper["tol"].float()[trial_map]
            lam_s = lam_max[split_of]  # [Bblk]
            step_b = 1.0 / (0.5 * Cb * lam_s[None, :] + lam + 1e-6)

            # fixed-length loop (capped at the bucket's largest max_iter by
            # bucket_static's _iters): no host sync inside the fit
            f32 = dict(dtype=torch.float32, device=X.device)
            W = torch.zeros((n_wb, dpp, NB), **f32)
            Wp = torch.zeros((n_wb, dpp, NB), **f32)
            done = torch.zeros((n_wb, Bblk), dtype=torch.bool, device=X.device)
            tr = torch.zeros((tr_used, n_wb, Bblk), **f32) if capture else None

            if use_fused:
                for t in range(steps):
                    W, Wp, gmax = packed_nesterov_step(
                        Ab, W, Wp, y2, WSP, float(t), done.float(), step_b,
                        Cb, maxit_b, pen_col, c=c, S=S, Tw=Tw, lam=lam,
                    )
                    done |= gmax < tol_b
                    if capture:
                        tr[t // tr_stride] = gmax
            else:
                step_full = step_b.repeat(1, c)[:, None, :]  # [n_wb, 1, NB]
                Cb_full = Cb.repeat(1, c)[:, None, :]
                for t in range(steps):  # legacy body
                    mom = float(np.float32(t) / np.float32(t + 3.0))
                    V = W + mom * (W - Wp)
                    Graw = packed_softmax_grad(
                        Ab, V.to(torch.bfloat16), y2, WSP, c=c, S=S, Tw=Tw
                    )
                    G = Cb_full * Graw + lam * pen_row * V
                    gmax = G.abs().reshape(n_wb, dpp, c, Bblk).amax(dim=(1, 2))
                    active = (float(t) < maxit_b) & ~done
                    act = active.repeat(1, c)[:, None, :]
                    W, Wp = torch.where(act, V - step_full * G, W), torch.where(act, W, Wp)
                    done |= gmax < tol_b
                    if capture:
                        tr[t // tr_stride] = gmax

            # ---- eval: row chunks, argmax over the class axis (f32) ----
            acc = torch.zeros((n_wb, Bblk), **f32)
            for start in range(0, n_pad, rc):
                a = Ab[start:start + rc].float()
                logits = torch.einsum("rd,wdn->wrn", a, W)
                pred = logits.reshape(n_wb, rc, c, Bblk).argmax(dim=2)
                yc = y_pad[start:start + rc]
                # slice the [S, n_pad] fold weights first, then expand to
                # the trial columns
                wev = EWp[:, start:start + rc][split_of].T  # [rc, Bblk]
                hit = (pred == yc[None, :, None]).float()
                acc += (hit * wev[None]).sum(dim=1)
            den = torch.clamp(EW.float().sum(dim=1), min=1e-12)  # [S]
            score_b = acc / den[split_of][None, :]
            score = score_b.reshape(n_wb, S, Tw).transpose(1, 2).reshape(chunk, S)
            out = {"score": score}
            if capture:
                # same lane -> (trial, split) mapping as score, with the
                # trace-slot axis carried along as a trailing dim
                out["curve_gmax"] = (
                    tr.permute(1, 2, 0).reshape(n_wb, S, Tw, tr_used)
                    .permute(0, 2, 1, 3).reshape(chunk, S, tr_used)
                )
                out["curve_stride"] = torch.full((chunk, S), float(tr_stride), **f32)
                out["curve_steps"] = torch.full((chunk, S), float(steps), **f32)
            return out

        return fn


def _onehot(y: torch.Tensor, c: int) -> torch.Tensor:
    return (y.long()[:, None] == torch.arange(c, device=y.device)).float()


def _force_packed() -> bool:
    """CS230_FORCE_PACKED=1 takes the packed path on any device and n (the
    CPU runs the kernels' plain versions): test coverage of the path."""
    return os.environ.get("CS230_FORCE_PACKED", "") == "1"


def _masked_grad_mode() -> str:
    mode = os.environ.get("CS230_MASKED_GRAD", "auto").lower()
    return mode if mode in ("auto", "xla", "pallas", "legacy") else "auto"


def _fused_step_mode() -> str:
    mode = os.environ.get("CS230_FUSED_STEP", "auto").lower()
    return mode if mode in ("auto", "pallas", "legacy") else "auto"


def _packed_geometry(static, n, d, n_classes, n_splits):
    """Shape/penalty derivation of the packed path."""
    c = max(int(n_classes), 2)
    fit_intercept = bool(static.get("fit_intercept", True))
    use_pen = static.get("penalty") in ("l2",)
    lam = (2.0 if n_classes == 2 else 1.0) if use_pen else 0.0
    dp = d + (1 if fit_intercept else 0)
    rc = 2048
    return {
        "c": c,
        "S": int(n_splits),
        "fit_intercept": fit_intercept,
        "lam": lam,
        "dp": dp,
        "dpp": pad_to_multiple(dp, 64),
        "rc": rc,
        "n_pad": pad_to_multiple(n, rc),
    }


def _padded_design(X, fit_intercept: bool, dpp: int, n_pad: int) -> torch.Tensor:
    """``[X | 1]`` zero-padded to ``[n_pad, dpp]`` f32: the packed path's A."""
    A = add_intercept(X, fit_intercept)
    return torch.nn.functional.pad(A, (0, dpp - A.shape[1], 0, n_pad - A.shape[0]))


def _lam_max(A: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-split Lipschitz bound ``lam_max(A' diag(w_s) A)`` by a 30-step
    power iteration plus the Rayleigh quotient, f32. w [S, n] -> [S]."""

    def apply(v):  # [S, dp] -> A' diag(w_s) A v_s for every split
        return (w * (v @ A.T)) @ A

    v = A.new_ones((w.shape[0], A.shape[1]))
    for _ in range(30):
        u = apply(v)
        v = u / torch.clamp(torch.linalg.vector_norm(u, dim=1, keepdim=True), min=1e-12)
    return torch.sum(v * apply(v), dim=1)


def _mm_bf16(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with bf16-rounded operands and f32 accumulation (the
    reference's ``preferred_element_type=f32`` bf16 dot): bf16 products are
    exact in f32, and TF32 is off, so the f32 einsum adds them in f32."""
    return torch.einsum(eq, a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float())


def _make_masked_grad_fn(A, Y, y, w, C, lam, pen_mask, mode):
    """Per-iteration masked gradient of the lane batch ``W [T, S, dp, c]``
    for the nesterov driver (bf16 operands, f32 accumulation)."""
    Cl = C[:, None, None, None]
    if mode == "legacy":
        def grad_fn(W):
            P = torch.softmax(_mm_bf16("nd,tsdc->tsnc", A, W), dim=-1)
            R = w[None, :, :, None] * (P - Y)
            return Cl * _mm_bf16("nd,tsnc->tsdc", A, R) + lam * pen_mask * W
        return grad_fn

    n, dp = A.shape
    c = Y.shape[1]
    dpp = pad_to_multiple(dp, 128)
    cp = pad_to_multiple(c, 16)
    from ..ops.cuda_logreg import masked_grad_applicable, masked_softmax_grad

    use_kernel = mode == "pallas" or (
        mode == "auto"
        and (_force_packed() or (A.device.type == "cuda" and n >= 4096))
        and masked_grad_applicable(dpp, cp)
    )
    if use_kernel:
        bm = 256
        n_pad = pad_to_multiple(n, bm)
        # loop-invariant paddings: made once per fit, reused every step
        Ab = torch.nn.functional.pad(A, (0, dpp - dp, 0, n_pad - n)).to(torch.bfloat16)
        y2 = torch.nn.functional.pad(y.to(torch.int32), (0, n_pad - n))[:, None].contiguous()
        S = w.shape[0]
        T = C.shape[0]
        # lane l = t * S + s carries split s's fold weights
        wm = torch.nn.functional.pad(w, (0, n_pad - n)).T.repeat(1, T).contiguous()

        def grad_fn(W):
            Wl = torch.nn.functional.pad(W, (0, cp - c, 0, dpp - dp))
            Wl = Wl.reshape(T * S, dpp, cp).to(torch.bfloat16).contiguous()
            Gk = masked_softmax_grad(Ab, Wl, y2, wm, c=c)
            Gk = Gk.reshape(T, S, dpp, cp)[:, :, :dp, :c]
            return Cl * Gk + lam * pen_mask * W
        return grad_fn

    WY = w[:, :, None] * Y  # [S, n, c] loop-invariant, hoisted out of the loop

    def grad_fn(W):
        # w * softmax(Z) with the mask folded into the per-row normalizer
        Z = _mm_bf16("nd,tsdc->tsnc", A, W)
        e = torch.exp(Z - Z.amax(dim=-1, keepdim=True))
        scale = (w[None] / e.sum(dim=-1))[..., None]
        return Cl * _mm_bf16("nd,tsnc->tsdc", A, e * scale - WY) + lam * pen_mask * W
    return grad_fn


def _trace_buf(steps: int, trace: bool, shape, like: torch.Tensor):
    """(stride, buffer [used, *shape]) for the in-loop grad-norm trace;
    ``(1, None)`` when capture is off."""
    if not trace:
        return 1, None
    from ..obs.curves import trace_stride

    stride = trace_stride(int(steps))
    used = -(-int(steps) // stride)
    return stride, like.new_zeros((used,) + tuple(shape))


def _newton(A, Y, w, W0, C, lam, pen_mask, max_iter, tol, steps=_NEWTON_STEPS,
            fused=True, trace=False):
    """Damped Newton over the lane batch W0 [T, S, dp, c]; w [S, n] fit
    masks, C / max_iter / tol [T]. Returns (W, trace [P', T, S] or None)."""
    T, S, dp, c = W0.shape
    n = A.shape[0]
    dim = dp * c
    Lanes = T * S
    W = W0.reshape(Lanes, dp, c)
    wl = w[None].expand(T, S, n).reshape(Lanes, n)  # lane fit masks
    Cl = C[:, None].expand(T, S).reshape(Lanes)
    wc = Cl[:, None] * wl  # [L, n]
    max_iter_l = max_iter[:, None].expand(T, S).reshape(Lanes)
    tol_l = tol[:, None].expand(T, S).reshape(Lanes)
    pen = lam * pen_mask
    # tiny ridge on the unpenalized (intercept) entries breaks the softmax
    # gauge direction that would otherwise make the Hessian singular
    pen_diag = torch.diag((pen + 1e-5 * (1.0 - pen_mask)).reshape(-1))
    eye = torch.eye(dim, dtype=A.dtype, device=A.device)
    eye_c = torch.eye(c, dtype=A.dtype, device=A.device)
    alphas = torch.tensor([1.0, 0.5, 0.25, 0.1, 0.02], dtype=A.dtype, device=A.device)
    # the masked label term wc*Y is loop-invariant
    WYc = wc[:, :, None] * Y

    def objective(Wb):  # [..., L, dp, c] -> [..., L]
        logp = torch.log_softmax(torch.einsum("nd,...dc->...nc", A, Wb), dim=-1)
        nll = -torch.sum(wl * torch.sum(Y * logp, dim=-1), dim=-1)
        return Cl * nll + 0.5 * torch.sum(pen * Wb * Wb, dim=(-2, -1))

    stride, tr = _trace_buf(steps, trace, (Lanes,), A)
    done = torch.zeros(Lanes, dtype=torch.bool, device=A.device)
    for t in range(steps):
        P = torch.softmax(torch.einsum("nd,ldc->lnc", A, W), dim=-1)  # [L, n, c]
        WP = wc[:, :, None] * P
        if fused:
            G = torch.einsum("nd,lnc->ldc", A, WP - WYc) + pen * W
        else:
            R = wl[:, :, None] * (P - Y)
            G = Cl[:, None, None] * torch.einsum("nd,lnc->ldc", A, R) + pen * W
        # H[(i,a),(j,b)] = sum_n wc_n A_ni A_nj (P_na δab − P_na P_nb)
        blocks = torch.einsum("ni,lna,nj->laij", A, WP, A)  # [L, c, dp, dp]
        H = torch.einsum("laij,ab->liajb", blocks, eye_c).reshape(Lanes, dim, dim)
        U = (A[None, :, :, None] * P[:, :, None, :]).reshape(Lanes, n, dim)
        UW = (A[None, :, :, None] * WP[:, :, None, :]).reshape(Lanes, n, dim)
        H = H - U.transpose(1, 2) @ UW + pen_diag + 1e-6 * eye
        delta, info = torch.linalg.solve_ex(H, G.reshape(Lanes, dim))
        delta = delta.reshape(Lanes, dp, c)
        # ill-conditioned solves can yield non-finite deltas: fall back to a
        # normalized gradient step
        ok = torch.isfinite(delta).all(dim=(1, 2)) & (info == 0)
        gnorm = torch.linalg.vector_norm(G, dim=(1, 2)) + 1e-12
        delta = torch.where(ok[:, None, None], delta, G / gnorm[:, None, None])
        # backtracking: the candidate step with the lowest objective
        objs = objective(W[None] - alphas[:, None, None, None] * delta[None])  # [5, L]
        best = torch.argmin(objs, dim=0)
        best_obj = objs.gather(0, best[None])[0]
        alpha = torch.where(best_obj < objective(W), alphas[best], torch.zeros_like(best_obj))
        gmax = G.abs().amax(dim=(1, 2))
        active = (float(t) < max_iter_l) & ~done
        # select, don't multiply: 0 * non-finite delta would poison W
        take = active & (alpha > 0.0)
        W = torch.where(take[:, None, None], W - alpha[:, None, None] * delta, W)
        done = done | (gmax < tol_l)
        if trace:
            tr[t // stride] = gmax
    trace_out = tr.reshape(-1, T, S) if trace else None
    return W.reshape(T, S, dp, c), trace_out


def _nesterov(A, w, W0, grad_fn, C, lam, max_iter, tol, steps=_NESTEROV_STEPS,
              trace=False):
    """Nesterov accelerated gradient over the lane batch W0 [T, S, dp, c]
    with a per-lane Lipschitz step. Returns (W, trace [P', T, S] or None)."""
    T, S = W0.shape[:2]
    # Lipschitz bound: L <= 0.5 * C * lambda_max(A' diag(w) A) + lam
    L = 0.5 * C[:, None] * _lam_max(A, w)[None, :] + lam + 1e-6  # [T, S]
    step = (1.0 / L)[:, :, None, None]
    stride, tr = _trace_buf(steps, trace, (T, S), A)
    W, W_prev = W0, W0
    done = torch.zeros((T, S), dtype=torch.bool, device=A.device)
    for t in range(steps):
        mom = float(np.float32(t) / np.float32(t + 3.0))
        V = W + mom * (W - W_prev)
        G = grad_fn(V)
        gmax = G.abs().amax(dim=(2, 3))  # [T, S]
        active = ((float(t) < max_iter[:, None]) & ~done)[:, :, None, None]
        W, W_prev = torch.where(active, V - step * G, W), torch.where(active, W, W_prev)
        done = done | (gmax < tol[:, None])
        if trace:
            # gmax is evaluated even once the lane is done (the update is
            # what is masked), so the trace tail freezes at convergence
            tr[t // stride] = gmax
    return W, tr


# ---------------------------------------------------------------------------
# out-of-core streamed nesterov (parallel/trial_map.py::_run_streamed)
# ---------------------------------------------------------------------------
#
# _nesterov restructured around row blocks (JAX ``models/logistic.py:833``):
# every quantity the solver reduces over rows (the power iteration's
# application, the masked gradient, the weighted-accuracy numerator) is a
# sum of per-block partial reductions, accumulated in f32 across one
# streamed pass per solver step. Block order is fixed (ascending), so
# results are deterministic; they differ from the single-shot values only
# by f32 summation order. The lane axes stay batched on the device:
# resident state is W / W_prev / V / G at [T, S, dp, c] plus the fold
# tensors, independent of n. The block products are plain f32 matmuls (the
# gradient's operands bf16-rounded, as in the reference's bf16 dot), not
# kernels, as in the JAX package.


def _stream_nesterov_scores(streamer, y_pad, TW, EW, hyper_batch, static, n):
    dev = TW.device
    n_classes = int(static["_n_classes"])
    c = max(n_classes, 2)
    fit_intercept = bool(static.get("fit_intercept", True))
    use_penalty = static.get("penalty") in ("l2",)
    lam = (1.0 if use_penalty else 0.0) * (2.0 if n_classes == 2 else 1.0)

    def lanes(name):
        return torch.as_tensor(np.asarray(hyper_batch[name], np.float32), device=dev)

    C, max_iter, tol = lanes("C"), lanes("max_iter"), lanes("tol")
    T, S = C.shape[0], TW.shape[0]
    rows = int(streamer.plan.rows)
    dp = int(streamer.row_shape[0]) + (1 if fit_intercept else 0)
    steps = int(static.get("_iters", _NESTEROV_STEPS))
    TW, EW = TW.float(), EW.float()
    f32 = dict(dtype=torch.float32, device=dev)
    pen_mask = torch.ones((dp, c), **f32)
    if fit_intercept:
        pen_mask[-1, :] = 0.0

    def blocks():
        """(A, rows' labels, fit weights, eval weights) of every block of
        one pass."""
        for _i, start, blk in streamer.iter_blocks():
            sl = slice(start, start + rows)
            yield add_intercept(blk, fit_intercept), y_pad[sl], TW[:, sl], EW[:, sl]

    # Lipschitz bound: _lam_max's 30-step power iteration plus the
    # Rayleigh quotient, 31 streamed applications of A' diag(w) A
    v = torch.ones((S, dp), **f32)
    for it in range(31):
        u = torch.zeros((S, dp), **f32)
        for A, _yb, wb, _ in blocks():
            u = u + (wb * (v @ A.T)) @ A
        if it < 30:
            v = u / torch.clamp(torch.linalg.vector_norm(u, dim=1, keepdim=True), min=1e-12)
    lam_max = torch.sum(v * u, dim=1)  # [S]
    L = 0.5 * C[:, None] * lam_max[None, :] + lam + 1e-6  # [T, S]
    step = (1.0 / L)[:, :, None, None]

    W = torch.zeros((T, S, dp, c), **f32)
    Wp = W
    done = torch.zeros((T, S), dtype=torch.bool, device=dev)
    for t in range(steps):
        mom = float(np.float32(t) / np.float32(t + 3.0))
        V = W + mom * (W - Wp)
        G = torch.zeros((T, S, dp, c), **f32)
        for A, yb, wb, _ in blocks():
            # the fused masked-gradient formulation on one block: pad rows
            # have wb == 0, so their softmax and label terms vanish exactly
            Z = _mm_bf16("rd,tsdc->tsrc", A, V)
            e = torch.exp(Z - Z.amax(dim=-1, keepdim=True))
            scale = (wb[None] / e.sum(dim=-1))[..., None]
            WY = wb[:, :, None] * _onehot(yb, c)[None]  # [S, rows, c]
            G = G + _mm_bf16("rd,tsrc->tsdc", A, e * scale - WY[None])
        G = C[:, None, None, None] * G + lam * pen_mask * V
        gmax = G.abs().amax(dim=(2, 3))  # [T, S]
        active = ((float(t) < max_iter[:, None]) & ~done)[:, :, None, None]
        W, Wp = torch.where(active, V - step * G, W), torch.where(active, W, Wp)
        done = done | (gmax < tol[:, None])
        # host-visible early exit: once every lane is converged or past its
        # max_iter, the remaining steps would be masked no-ops, each a pass
        if bool((done | (float(t + 1) >= max_iter[:, None])).all()):
            break

    acc = torch.zeros((T, S), **f32)
    for A, yb, _, ewb in blocks():
        hit = (torch.einsum("rd,tsdc->tsrc", A, W).argmax(dim=-1) == yb.long()).float()
        acc = acc + torch.einsum("sr,tsr->ts", ewb, hit)
    den = torch.clamp(EW.sum(dim=1), min=1e-12)
    return (acc / den[None, :]).cpu().numpy()
