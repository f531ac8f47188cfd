"""MLP kernels (classifier + regressor), sklearn-MLP semantics, batched over
(trial, split) lanes.

Port of the JAX package's ``models/mlp.py``. sklearn's MLPClassifier /
MLPRegressor defaults: relu hidden layers, minibatch Adam (batch 200), L2
penalty ``alpha``, log-loss / squared-loss. Architecture
(``hidden_layer_sizes``), activation, batch size, solver and epoch count
are static (trials are bucketed by them); ``alpha`` and
``learning_rate_init`` are traced ``[T]`` hypers.

Minibatching under the split-mask regime: batches are fixed random
permutation slices of the whole dataset with per-sample weights multiplying
the loss, so rows outside a lane's split contribute no gradient. The
random streams are the reference's (``utils/prng.py``): the Glorot init,
the per-epoch permutations and the stochastic rounding of the bf16 second
moment, all from ``PRNGKey(random_state)``; every lane of a bucket shares
them.

Two paths, as in the JAX package:

- **generic** (``fit`` / ``fit_curve`` / ``evaluate``): the whole fit over
  an explicit lane axis with bf16-operand products, Adam with a bf16 first
  moment and a stochastically rounded bf16 second moment
  (``CS230_MLP_V_DTYPE``), or SGD with its three learning-rate schedules;
  the backward pass rounds where ``jax.grad`` of the reference's bf16
  products does. With ``CS230_CURVES`` on (the default) it emits the
  ``curve_loss`` / ``curve_gmax`` leaves.
- **fused** (``build_batched_fn``): on the card at n >= 4096 (or with
  ``CS230_FORCE_PACKED=1`` anywhere) each epoch is one launch of the epoch
  kernel (``ops/cuda_mlp.py``, kernel B5) over every lane, then a
  row-chunked eval. On the CPU the kernel's plain version runs in f32,
  as the JAX fused path runs in interpret mode. With ``CS230_CURVES`` on
  it emits a per-epoch ``curve_loss`` leaf, from the kernel's loss
  accumulator (the epoch loss of the adaptive schedule). The JAX fused
  path emits no curve; this one does so that the numerical-health
  watchdog sees a diverging trial on the card's route too.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import torch

from ..ops import cuda_mlp
from ..ops.cuda_mlp import activate
from ..utils import prng
from .base import ModelKernel, score_lanes, to_host
from .logistic import _force_packed

_EPOCH_CAP = 100
#: eval row chunk of the fused path
_EVAL_ROWS = 256


def _v_dtype_mode() -> str:
    """Storage dtype of the generic path's second Adam moment: ``bf16``
    (default, stochastic rounding) or ``f32``."""
    mode = os.environ.get("CS230_MLP_V_DTYPE", "bf16").lower()
    return mode if mode in ("bf16", "f32") else "bf16"


def _rb(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back to f32."""
    return x.to(torch.bfloat16).float()


def _sr_bf16(x32: torch.Tensor, key) -> torch.Tensor:
    """Stochastically round non-negative finite f32 to bf16: add 16 random
    bits below the bf16 mantissa, then truncate (the reference's
    ``_sr_bf16``, bit for bit). The bits are drawn for ``key`` at the
    shape of ``x32``'s trailing dims, so every lane of a batch gets the
    same bits, as under the reference's vmap."""
    return _sr_bf16_with(x32, prng.bits(key, x32.shape[1:]))


def _sr_bf16_with(x32: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """``_sr_bf16`` with its random bits (``[*x32.shape[1:]]``) drawn."""
    u = x32.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + (bits & 0xFFFF)) & 0xFFFF0000
    return u.to(torch.int32).view(torch.float32).to(torch.bfloat16)


def _act_backward(name: str, ct: torch.Tensor, z: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The cotangent of the activation's input, in the reference's own
    arithmetic (JAX's derivative rules)."""
    if name == "relu":
        return torch.where(z > 0, ct, torch.zeros_like(ct))
    if name == "tanh":
        return (ct + ct * a) * (1.0 - a)
    if name == "logistic":
        return ct * (a * (1.0 - a))
    return ct


class _MLPBase(ModelKernel):
    hyper_defaults = {"alpha": 1e-4, "learning_rate_init": 1e-3}
    static_defaults = {
        "hidden_layer_sizes": (100,),
        "activation": "relu",
        "batch_size": "auto",
        "max_iter": 200,
        "random_state": 0,
        "solver": "adam",
        "beta_1": 0.9,
        "beta_2": 0.999,
        "epsilon": 1e-8,
        "shuffle": True,
        "early_stopping": False,
        "tol": 1e-4,
        "learning_rate": "constant",
        "momentum": 0.9,
        "n_iter_no_change": 10,
        "nesterovs_momentum": True,
        "power_t": 0.5,
        "validation_fraction": 0.1,
        "max_fun": 15000,
    }
    ignored_params = ModelKernel.ignored_params - {"random_state", "solver", "max_fun"}

    def resolve_static(self, static: Dict[str, Any], n: int, d: int, n_classes: int):
        hls = static.get("hidden_layer_sizes", (100,))
        if isinstance(hls, (int, float)):
            hls = (int(hls),)
        hls = tuple(int(h) for h in hls)
        bs = static.get("batch_size", "auto")
        bs = min(200, n) if bs == "auto" else min(int(bs), n)
        epochs = min(int(static.get("max_iter", 200)), _EPOCH_CAP)
        if static.get("activation", "relu") not in cuda_mlp.ACTIVATIONS:
            raise ValueError(f"MLP: unsupported activation {static.get('activation')!r}")
        if static.get("solver", "adam") not in ("adam", "sgd"):
            raise ValueError(
                f"MLP: unsupported solver {static.get('solver')!r} "
                "(supported: adam, sgd)"
            )
        if static.get("learning_rate", "constant") not in (
            "constant", "invscaling", "adaptive"
        ):
            raise ValueError(
                f"MLP: unsupported learning_rate {static.get('learning_rate')!r}"
            )
        return {
            **static,
            "_hls": hls,
            "_bs": bs,
            "_epochs": epochs,
            "_seed": int(static.get("random_state") or 0),
        }

    def _dims(self, d: int, static: Dict[str, Any]) -> Tuple[int, ...]:
        return (d, *static["_hls"], self._out_dim(static))

    def macs_estimate(self, n, d, static):
        """fwd+bwd over all layer matmuls x epochs (3x fwd MAC rule)."""
        dims = self._dims(d, static)
        layer_macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
        bs = int(static["_bs"])
        n_batches = max(1, n // bs)
        return 3.0 * static["_epochs"] * n_batches * bs * layer_macs

    def memory_estimate_mb(self, n, d, static):
        """Per-(trial, split) working set: params + Adam moments + the
        step's batch activations (the [n, d] dataset is shared by every
        lane and not counted here)."""
        dims = self._dims(d, static)
        wparams = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        bs = int(static.get("_bs", 200))
        v_bytes = 2 if _v_dtype_mode() == "bf16" else 4
        state_mb = wparams * (4 + 2 + v_bytes) / 1e6
        act_mb = 3.0 * bs * sum(dims) * 4 / 1e6
        return max(1.0, state_mb + act_mb + 1.0)

    def _init(self, key, dims) -> List[Dict[str, torch.Tensor]]:
        """sklearn's Glorot-uniform init (factor 6), the reference's draws."""
        params = []
        for i in range(len(dims) - 1):
            key, sub = prng.split(key).unbind(-2)
            fan_in, fan_out = dims[i], dims[i + 1]
            bound = float(torch.sqrt(torch.tensor(6.0 / (fan_in + fan_out), dtype=torch.float32)))
            W = prng.uniform(sub, (fan_in, fan_out), -bound, bound)
            params.append({"W": W, "b": torch.zeros((fan_out,), dtype=torch.float32,
                                                    device=key.device)})
        return params

    def _forward(self, params, X, static):
        """f32 logits of one model (a list of ``{"W", "b"}``)."""
        act = static.get("activation", "relu")
        h = X.float()
        for layer in params[:-1]:
            h = activate(act, h @ layer["W"] + layer["b"])
        return h @ params[-1]["W"] + params[-1]["b"]

    # ---- generic path: the fit over an explicit lane axis -----------------

    def batched_scores(self, X, y, TW, EW, hyper, static):
        """``[T, S]`` scores (lane = trial * S + split): ``fit`` (or
        ``fit_curve`` with curve capture on) and ``evaluate`` per lane."""
        from ..obs.curves import curves_enabled

        T, S = next(iter(hyper.values())).shape[0], TW.shape[0]
        hyper_l = {k: v.repeat_interleave(S) for k, v in hyper.items()}
        if curves_enabled():
            fitted, curve = self.fit_curve(X, y, TW.repeat(T, 1), hyper_l, static)
        else:
            fitted, curve = self.fit(X, y, TW.repeat(T, 1), hyper_l, static), {}
        out = dict(self.evaluate(fitted, X, y, EW.repeat(T, 1), static))
        out.update({"curve_" + k: v for k, v in curve.items()})
        return {k: v.reshape(T, S, *v.shape[1:]) for k, v in out.items()}

    def fit(self, X, y, w, hyper: Dict[str, torch.Tensor], static: Dict[str, Any]):
        """Lane-batched params: a list of ``{"W": [L, din, dout], "b": [L,
        dout]}`` for fit masks ``w [L, n]`` and hypers ``[L]``."""
        return self._fit(X, y, w, hyper, static, trace=False)[0]

    def fit_curve(self, X, y, w, hyper: Dict[str, torch.Tensor], static: Dict[str, Any]):
        """The same fit plus bounded traces: per-step loss and max|grad| on
        the Adam path, per-epoch loss on the SGD path (``[L, P]`` each,
        with ``stride`` and ``steps`` per lane). Returns ``(params,
        curve)``."""
        return self._fit(X, y, w, hyper, static, trace=True)

    def artifact_params(self, params, lane: int = 0):
        """The JAX layout: a list of ``{"W": [din, dout], "b": [dout]}``."""
        return [{k: to_host(layer[k][lane]) for k in ("W", "b")} for layer in params]

    def params_from_artifact(self, np_params, device):
        """One model (``predict`` takes a single model, not lanes)."""
        return cuda_mlp.params_from_jax(np_params, device)

    def _loss_grad(self, params, xb, tb, wb, alpha, static):
        """Loss (mean weighted batch loss plus ``alpha/2 ||W||^2`` over the
        batch weight) and its gradient for every lane, by hand, rounding
        where ``jax.grad`` of the reference's bf16 products rounds: the
        gradient of a bf16 operand is bf16. xb [bs, d], tb [bs, c], wb
        [L, bs], alpha [L]."""
        act = static.get("activation", "relu")
        n_layers = len(params)
        zs, hs = [], [xb]
        h = xb
        for li, layer in enumerate(params):
            eq = "bd,ldh->lbh" if li == 0 else "lbd,ldh->lbh"
            z = torch.einsum(eq, _rb(h), _rb(layer["W"])) + layer["b"][:, None, :]
            zs.append(z)
            if li < n_layers - 1:
                h = activate(act, z)
                hs.append(h)
        pred = zs[-1]
        batch_w = torch.clamp(wb.sum(dim=1), min=1e-12)  # [L]
        ct_row = wb / batch_w[:, None]  # d data_loss / d row loss
        if self.task == "classification":
            logp = torch.log_softmax(pred, dim=-1)
            row_loss = -torch.sum(tb * logp, dim=-1)
            ct_logp = -tb * ct_row[:, :, None]
            dz = ct_logp - torch.exp(logp) * ct_logp.sum(dim=-1, keepdim=True)
        else:
            diff = pred - tb
            row_loss = 0.5 * torch.sum(diff ** 2, dim=-1)
            dz = ct_row[:, :, None] * diff
        l2 = sum(torch.sum(layer["W"] ** 2, dim=(1, 2)) for layer in params)
        loss = torch.sum(row_loss * wb, dim=1) / batch_w + 0.5 * alpha * l2 / batch_w
        coef = (alpha / batch_w)[:, None, None]
        grads: List[Dict[str, torch.Tensor]] = [None] * n_layers
        for li in range(n_layers - 1, -1, -1):
            W = params[li]["W"]
            eq = "bd,lbh->ldh" if li == 0 else "lbd,lbh->ldh"
            gW = _rb(torch.einsum(eq, _rb(hs[li]), dz)) + coef * W
            grads[li] = {"W": gW, "b": dz.sum(dim=1)}
            if li > 0:
                ct_h = _rb(torch.einsum("lbh,ldh->lbd", dz, _rb(W)))
                dz = _act_backward(act, ct_h, zs[li - 1], hs[li])
        return loss, grads

    def _fit(self, X, y, w, hyper, static, trace: bool):
        X = X.float()
        w = w.float()
        n = X.shape[0]
        L = w.shape[0]
        bs = int(static["_bs"])
        epochs = int(static["_epochs"])
        n_batches = max(1, n // bs)
        alpha = hyper["alpha"].float()
        lr = hyper["learning_rate_init"].float()
        b1 = float(static.get("beta_1", 0.9))
        b2 = float(static.get("beta_2", 0.999))
        eps = float(static.get("epsilon", 1e-8))
        dims = self._dims(X.shape[1], static)

        key = prng.PRNGKey(static["_seed"], device=X.device)
        key, init_key = prng.split(key).unbind(-2)
        params = [{k: v[None].repeat((L,) + (1,) * v.dim()) for k, v in layer.items()}
                  for layer in self._init(init_key, dims)]
        target = self._target(y, static)
        perm_keys = prng.split(key, epochs)
        batches = [prng.permutation(perm_keys[e], n)[: n_batches * bs].reshape(n_batches, bs)
                   for e in range(epochs)]

        if static.get("solver", "adam") == "sgd":
            return self._fit_sgd(X, target, w, params, batches, lr, alpha, static, n, trace)

        total = epochs * n_batches
        if trace:
            from ..obs.curves import trace_stride

            stride = trace_stride(total)
            tr_loss = X.new_zeros((L, -(-total // stride)))
            tr_gmax = torch.zeros_like(tr_loss)

        bf16 = torch.bfloat16
        v_bf16 = _v_dtype_mode() == "bf16"
        m = [{k: torch.zeros_like(v, dtype=bf16) for k, v in layer.items()} for layer in params]
        v = [{k: torch.zeros_like(x, dtype=bf16 if v_bf16 else torch.float32)
              for k, x in layer.items()} for layer in params]
        if v_bf16:
            # every step's per-leaf keys at once (step s: split(fold_in(sr_key,
            # s)), leaves in the reference's flatten order: W before b, layer
            # by layer), and each step's bits in one threefry pass
            sr_key = prng.fold_in(key, 0x5A)  # stochastic-rounding stream
            steps_d = torch.arange(1, total + 1, dtype=torch.int64, device=X.device)
            step_keys = prng.split(prng.fold_in(sr_key, steps_d), 2 * len(params))
            leaf_shapes = [layer[name].shape[1:] for layer in params for name in ("W", "b")]
        f32 = torch.float32
        lr3, lr2 = lr[:, None, None], lr[:, None]
        step = 0
        for e in range(epochs):
            for b in range(n_batches):
                idx = batches[e][b]
                loss, g = self._loss_grad(params, X[idx], target[idx], w[:, idx], alpha, static)
                if trace:
                    gmax = torch.stack([leaf.abs().amax(dim=tuple(range(1, leaf.dim())))
                                        for layer in g for leaf in (layer["W"], layer["b"])])
                    tr_loss[:, step // stride] = loss
                    tr_gmax[:, step // stride] = gmax.amax(dim=0)
                step += 1
                t = torch.tensor(float(step), dtype=f32, device=X.device)
                bc1 = 1 - torch.pow(torch.tensor(b1, dtype=f32, device=X.device), t)
                bc2 = 1 - torch.pow(torch.tensor(b2, dtype=f32, device=X.device), t)
                if v_bf16:
                    sr_bits = prng.random_bits_each(step_keys[step - 1], leaf_shapes)
                for li in range(len(params)):
                    for j, name in enumerate(("W", "b")):
                        gg = g[li][name]
                        m[li][name] = (b1 * m[li][name].float() + (1 - b1) * gg).to(bf16)
                        v32 = b2 * v[li][name].float() + (1 - b2) * gg * gg
                        v[li][name] = _sr_bf16_with(v32, sr_bits[2 * li + j]) if v_bf16 else v32
                        lr_ = lr3 if gg.dim() == 3 else lr2
                        mhat = m[li][name].float() / bc1
                        vhat = v[li][name].float() / bc2
                        params[li][name] = params[li][name] - lr_ * mhat / (torch.sqrt(vhat) + eps)
        if not trace:
            return params, None
        return params, {
            "loss": tr_loss,
            "gmax": tr_gmax,
            "stride": X.new_full((L,), float(stride)),
            "steps": X.new_full((L,), float(total)),
        }

    def _fit_sgd(self, X, target, w, params, batches, lr0, alpha, static, n, trace):
        """sklearn SGDOptimizer semantics: velocity momentum (plain or
        Nesterov) with the three learning-rate schedules: ``constant``;
        ``invscaling`` lr = lr_init / (t+1)^power_t with t advancing by n
        samples per epoch; ``adaptive`` divides lr by 5 once the epoch loss
        fails to improve by ``tol`` for n_iter_no_change+1 consecutive
        epochs (floored at 1e-6). The full max_iter budget runs."""
        momentum = float(static.get("momentum", 0.9))
        nesterov = bool(static.get("nesterovs_momentum", True))
        schedule = static.get("learning_rate", "constant")
        power_t = float(static.get("power_t", 0.5))
        tol = float(static.get("tol", 1e-4))
        no_change = int(static.get("n_iter_no_change", 10))
        L = w.shape[0]
        epochs = len(batches)
        if trace:
            from ..obs.curves import trace_stride

            stride = trace_stride(epochs)
            tr = X.new_zeros((L, -(-epochs // stride)))

        vel = [{k: torch.zeros_like(x) for k, x in layer.items()} for layer in params]
        lr_t = lr0 * 1.0  # [L]
        t_samples = torch.tensor(0.0, dtype=torch.float32, device=X.device)
        best = X.new_full((L,), float("inf"))
        wait = torch.zeros((L,), dtype=torch.int32, device=X.device)
        for e in range(epochs):
            losses = []
            for idx in batches[e]:
                loss, g = self._loss_grad(params, X[idx], target[idx], w[:, idx], alpha, static)
                losses.append(loss)
                for li in range(len(params)):
                    for name in ("W", "b"):
                        gg = g[li][name]
                        lr_ = lr_t.reshape((L,) + (1,) * (gg.dim() - 1))
                        vel[li][name] = momentum * vel[li][name] - lr_ * gg
                        if nesterov:
                            params[li][name] = (params[li][name] + momentum * vel[li][name]
                                                - lr_ * gg)
                        else:
                            params[li][name] = params[li][name] + vel[li][name]
            epoch_loss = torch.stack(losses).mean(dim=0)
            if trace:
                tr[:, e // stride] = epoch_loss
            t_samples = t_samples + n
            if schedule == "invscaling":
                lr_t = lr0 / (t_samples + 1.0) ** power_t
            elif schedule == "adaptive":
                improved = epoch_loss < best - tol
                wait = torch.where(improved, torch.zeros_like(wait), wait + 1)
                cut = wait > no_change
                lr_t = torch.where(cut, torch.clamp(lr_t / 5.0, min=1e-6), lr_t)
                wait = torch.where(cut, torch.zeros_like(wait), wait)
                best = torch.minimum(best, epoch_loss)
        if not trace:
            return params, None
        return params, {
            "loss": tr,
            "stride": X.new_full((L,), float(stride)),
            "steps": X.new_full((L,), float(epochs)),
        }

    def _lane_forward(self, params, X, static):
        """f32 outputs ``[L, n, k]`` of lane-batched params, as the
        reference's predict."""
        act = static.get("activation", "relu")
        h = X.float()
        for li, layer in enumerate(params):
            eq = "nd,ldh->lnh" if li == 0 else "lnd,ldh->lnh"
            h = torch.einsum(eq, h, layer["W"]) + layer["b"][:, None, :]
            if li < len(params) - 1:
                h = activate(act, h)
        return h

    def evaluate(self, params, X, y, w, static) -> Dict[str, torch.Tensor]:
        """Per-lane score on the rows ``w [L, n]`` selects, by the job's
        scorer: labels, margin and probabilities of the f32 logits, or the
        regressor's output."""
        h = self._lane_forward(params, X, static)
        if self.task == "classification":
            return score_lanes(self, static, y, w, predict=lambda: h.argmax(dim=-1),
                               margin=lambda: h[..., 1] - h[..., 0],
                               proba=lambda: torch.softmax(h, dim=-1))
        return score_lanes(self, static, y, w, predict=lambda: h[..., 0])

    # ---- fused path (ops/cuda_mlp.py, kernel B5) --------------------------
    #
    # On the card, large buckets bypass the generic path: each epoch is one
    # launch of the epoch kernel over every (trial, split) lane, and the
    # eval runs in row chunks.

    batched_trial_multiple = 1
    batched_chunk_cap = 64

    def batched_applicable(self, static: Dict[str, Any], n: int, d: int,
                           device: torch.device) -> bool:
        if static.get("solver", "adam") not in ("adam", "sgd"):
            return False
        if not static.get("shuffle", True) or static.get("early_stopping"):
            return False
        if len(static["_hls"]) > 3:
            return False
        if _force_packed():
            return True
        return device.type == "cuda" and n >= 4096

    def build_batched_fn(self, static, n, d, n_classes, n_splits, chunk,
                         device: torch.device):
        """fn(X, y, TW, EW, hyper) -> {"score": [chunk, n_splits]} (plus
        "mse" for regressors): the fit through the epoch kernel, one launch
        an epoch, and the eval in row chunks. None where the fused path
        does not apply."""
        if not self.batched_applicable(static, n, d, device):
            return None
        solver = static.get("solver", "adam")
        b1 = float(static.get("beta_1", 0.9))
        b2 = float(static.get("beta_2", 0.999))
        eps = float(static.get("epsilon", 1e-8))
        # the kernel has sklearn's Adam constants built in; other values
        # take the generic path, which honours them
        if solver == "adam" and (b1, b2, eps) != (cuda_mlp.B1, cuda_mlp.B2, cuda_mlp.EPS):
            return None

        classification = self.task == "classification"
        c = self._out_dim(static)
        dims = self._dims(d, static)
        act = static.get("activation", "relu")
        bs = int(static["_bs"])
        epochs = int(static["_epochs"])
        n_batches = max(1, n // bs)
        R = n_batches * bs
        S = int(n_splits)
        L0 = chunk * S
        schedule = static.get("learning_rate", "constant")
        adaptive = solver == "sgd" and schedule == "adaptive"
        invscaling = solver == "sgd" and schedule == "invscaling"
        seed = int(static["_seed"])
        momentum = float(static.get("momentum", 0.9))
        nesterov = bool(static.get("nesterovs_momentum", True))
        power_t = float(static.get("power_t", 0.5))
        tol = float(static.get("tol", 1e-4))
        no_change = int(static.get("n_iter_no_change", 10))
        k = cuda_mlp.per_layer(solver)
        from ..obs.curves import curves_enabled, trace_stride, trace_update

        capture = curves_enabled()
        track = adaptive or capture  # the kernel accumulates the batch losses
        tr_stride = trace_stride(epochs)
        lane_split = torch.arange(L0, device=device) % S
        # operand precision: bf16 on the card (the kernel's); f32 on the
        # CPU, as the JAX fused path computes in interpret mode
        mdt = torch.bfloat16 if device.type == "cuda" else torch.float32
        kw = dict(dims=dims, act=act, bs=bs, n_batches=n_batches,
                  classification=classification, solver=solver, momentum=momentum,
                  nesterov=nesterov, track_loss=track)
        f32 = torch.float32

        def mm(eq, a, b):
            return torch.einsum(eq, a.to(mdt).float(), b.to(mdt).float())

        def fn(X, y, TW, EW, hyper):
            Xb = X.to(mdt)
            if classification:
                Y = (y.long()[:, None] == torch.arange(c, device=y.device)).float()
            else:
                Y = y.float()[:, None]
            TWf = TW.float()
            lr = hyper["learning_rate_init"].float().repeat_interleave(S).contiguous()
            alpha = hyper["alpha"].float().repeat_interleave(S).contiguous()

            key = prng.PRNGKey(seed, device=X.device)
            key, init_key = prng.split(key).unbind(-2)
            state = cuda_mlp.epoch_state(self._init(init_key, dims), L0, solver, track)
            ekeys = prng.split(key, epochs)
            lr_col = lr
            best = X.new_full((L0,), float("inf"))
            wait = torch.zeros((L0,), dtype=torch.int32, device=X.device)
            trace = X.new_zeros((-(-epochs // tr_stride), L0)) if capture else None
            for e in range(epochs):
                if invscaling:  # sklearn's t_ advances by n samples an epoch
                    lr_col = lr / (torch.tensor(float(e), dtype=f32, device=X.device) * n
                                   + 1.0) ** power_t
                perm = prng.permutation(ekeys[e], n)[:R]
                Wl = TWf[:, perm].T[:, lane_split].contiguous()  # [R, L0], lane-minor
                if track:
                    state[-1].zero_()
                cuda_mlp.epoch(Xb[perm].contiguous(), Y[perm].contiguous(), Wl,
                               lr_col.contiguous(), alpha, e * n_batches, state, **kw)
                if not track:
                    continue
                # the epoch's data loss plus the L2 term of the weights at
                # its end, over the mean batch weight
                data_loss = state[-1] / n_batches
                l2 = sum(torch.sum(state[k * li] ** 2, dim=(1, 2))
                         for li in range(len(dims) - 1))
                bw_mean = torch.clamp(Wl.sum(dim=0) / n_batches, min=1e-12)
                epoch_loss = data_loss + 0.5 * alpha * l2 / bw_mean
                if capture:
                    trace_update(trace, e, epoch_loss, tr_stride)
                if adaptive:
                    improved = epoch_loss < best - tol
                    wait = torch.where(improved, torch.zeros_like(wait), wait + 1)
                    cut = wait > no_change
                    lr_col = torch.where(cut, torch.clamp(lr_col / 5.0, min=1e-6), lr_col)
                    wait = torch.where(cut, torch.zeros_like(wait), wait)
                    best = torch.minimum(best, epoch_loss)

            curve = {}
            if capture:
                curve = {"curve_loss": trace.T.reshape(chunk, S, -1),
                         "curve_stride": X.new_full((chunk, S), float(tr_stride)),
                         "curve_steps": X.new_full((chunk, S), float(epochs))}

            # ---- eval: weighted score per lane over row chunks ----
            pWs = [state[k * li] for li in range(len(dims) - 1)]
            pBs = [state[k * li + 1][:, None, :] for li in range(len(dims) - 1)]
            n_pad = -(-n // _EVAL_ROWS) * _EVAL_ROWS
            Xe = torch.nn.functional.pad(Xb, (0, 0, 0, n_pad - n))
            EWp = torch.nn.functional.pad(EW.float(), (0, n_pad - n))
            ye = torch.nn.functional.pad(y.to(torch.int64 if classification else f32),
                                         (0, n_pad - n))

            def forward_chunk(start):
                out = mm("rd,ldh->lrh", Xe[start:start + _EVAL_ROWS], pWs[0]) + pBs[0]
                for li in range(1, len(pWs)):
                    out = mm("lrh,lhk->lrk", activate(act, out), pWs[li]) + pBs[li]
                return out, EWp[:, start:start + _EVAL_ROWS][lane_split]  # [L0, rc]

            starts = range(0, n_pad, _EVAL_ROWS)
            if classification:
                acc = X.new_zeros((L0,))
                for start in starts:
                    out, ewc = forward_chunk(start)
                    hit = (out.argmax(dim=-1) == ye[None, start:start + _EVAL_ROWS]).float()
                    acc = acc + torch.sum(hit * ewc, dim=1)
                den = torch.sum(EWp, dim=1)[lane_split]
                score = acc / torch.clamp(den, min=1e-12)
                return {"score": score.reshape(chunk, S), **curve}
            sw, swy, swyy, ssr = (X.new_zeros((L0,)) for _ in range(4))
            for start in starts:
                out, ewc = forward_chunk(start)
                yc = ye[None, start:start + _EVAL_ROWS]
                sw = sw + torch.sum(ewc, dim=1)
                swy = swy + torch.sum(ewc * yc, dim=1)
                swyy = swyy + torch.sum(ewc * yc * yc, dim=1)
                ssr = ssr + torch.sum(ewc * (yc - out[:, :, 0]) ** 2, dim=1)
            swc = torch.clamp(sw, min=1e-12)
            ss_tot = torch.clamp(swyy - swy * swy / swc, min=1e-12)
            return {"score": (1.0 - ssr / ss_tot).reshape(chunk, S),
                    "mse": (ssr / swc).reshape(chunk, S), **curve}

        return fn


class MLPClassifierKernel(_MLPBase):
    name = "MLPClassifier"
    task = "classification"

    def _out_dim(self, static):
        return max(int(static["_n_classes"]), 2)

    def _target(self, y, static):
        c = self._out_dim(static)
        return (y.long()[:, None] == torch.arange(c, device=y.device)).float()

    def predict(self, params, X, static: Dict[str, Any]):
        return self._forward(params, X, static).argmax(dim=-1).to(torch.int32)

    def predict_margin(self, params, X, static: Dict[str, Any]):
        logits = self._forward(params, X, static)
        return logits[:, 1] - logits[:, 0]

    def predict_proba(self, params, X, static: Dict[str, Any]):
        return torch.softmax(self._forward(params, X, static), dim=-1)


class MLPRegressorKernel(_MLPBase):
    name = "MLPRegressor"
    task = "regression"

    def _out_dim(self, static):
        return 1

    def _target(self, y, static):
        return y.float()[:, None]

    def predict(self, params, X, static: Dict[str, Any]):
        return self._forward(params, X, static)[:, 0]
