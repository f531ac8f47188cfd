"""Fused MLP training epoch: a hand-written CUDA kernel for Hopper.

Counterpart of the JAX package's ``ops/pallas_mlp.py``. One kernel, in
``csrc/mlp.cu``, beside its plain PyTorch version:

- ``epoch`` (replaces ``pallas_mlp.py:239``, ``build_epoch_fn``, body
  ``_epoch_kernel`` at ``:77``): one whole Adam or SGD minibatch epoch for
  L lanes (a lane is one trial x split fit), state updated in place.

Every lane shares the epoch-shuffled batch block. For each of the
``n_batches`` steps, in order, and for each lane: the forward pass through
up to 4 layers (relu, tanh, logistic or identity hidden layers), the output
gradient of the lane's split-weighted mean loss (softmax minus one-hot, or
the residual), the backward pass last layer first with
``gW = a^T dz + (alpha / bw) W`` and ``gB = sum_rows dz``, and the in-place
update (Adam with f32 moments and bias corrections ``1 - exp(t ln beta)``,
or SGD velocity momentum with or without Nesterov). With ``track_loss``
the lane's batch data loss accumulates into its loss entry.

Precision is part of the function. Every product rounds both operands to
bf16 and accumulates in f32 (the TPU kernel's ``_dot``), the bias products
included: the forward adds ``bf16(pB)`` and ``gB`` sums ``bf16(dz)``. The
plain version takes its operand precision from ``Xs``: bf16 rows mean the
kernel's rounding, f32 rows mean f32 products (what the Pallas kernel
computes in interpret mode on the CPU, where the JAX fused path passes f32
rows). The kernel takes bf16 rows only.

Layout. Per layer the state is ``(pW, pB, mW, mB, vW, vB)`` for adam or
``(pW, pB, velW, velB)`` for sgd, weights ``[L, din, dout]`` and biases
``[L, dout]`` f32, plus a trailing ``[L]`` f32 loss accumulator with
``track_loss``. The TPU kernel carries biases as ``[L, 8, dout]`` slabs of
identical rows and the loss as an ``[L, 8, 128]`` slab, a TPU layout rule
(``pallas_mlp.py:94-100``); ``state_from_jax`` takes those to this layout.
There is no lane grouping: the TPU kernel packs k lanes per grid step to
share a VMEM-resident batch block (``pick_k``, ``CS230_MLP_K16``); here
each lane is one CTA and the lanes share the batch through L2, so those
have no counterpart.

Dispatch. Given CPU tensors the wrapper computes the plain version; given
CUDA tensors it launches the kernel or raises. Nothing falls back from the
card to the plain version. ``LAUNCHES`` counts kernel launches (one per
epoch).

Residency and bounds (H100 SXM: 989 TFLOP/s bf16, 3.35 TB/s). The TPU
kernel keeps each lane's params and moments in VMEM for the whole epoch.
One lane of the widest config-5 net, 784-512-10, has 406,528 parameters,
4.9 MB of f32 p + m + v: no SM's 228 KB of shared memory holds it. So the
state lives in device memory and every step reads and writes it (24 bytes
a parameter for adam, plus a 2-byte bf16 shadow of every weight that the
products read), and the activations of the step go through a per-lane
scratch that stays in L2. The card's bound for one epoch is the
larger of its products over the bf16 rate and, in bytes, the state read
and written once plus the batch rows read once; this design's own floor
adds the state traffic of every step (``epoch_bytes``).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np
import torch

B1 = 0.9
B2 = 0.999
EPS = 1e-8
_LOG_B1 = float(np.log(B1))
_LOG_B2 = float(np.log(B2))

#: activation names and the kernel's codes for them
ACTIVATIONS = ("relu", "tanh", "logistic", "identity")
#: layers the kernel takes (up to 3 hidden layers and the output layer)
MAX_LAYERS = 4

#: kernel launches, for showing that a run went through the kernel
LAUNCHES = {"mlp_epoch": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# geometry and cost (pure shape arithmetic)
# ---------------------------------------------------------------------------


def per_layer(solver: str) -> int:
    """State tensors per layer: p, m, v of W and b for adam; p, vel for sgd."""
    return 6 if solver == "adam" else 4


def _pad(x: int, m: int) -> int:
    return -(-x // m) * m


def scratch_floats(dims: Sequence[int], bs: int) -> int:
    """Scratch one lane needs, in f32 units (``mlp_scratch_floats`` in
    csrc/mlp.cu; every piece starts 16-byte aligned): per layer a bf16
    shadow of W, ``[din][pad8(dout)]``; per hidden layer its f32
    activations ``[bs][dout]`` and their bf16 copy ``[bs][pad8(dout)]``;
    the f32 logits ``[bs][c]``; per layer the bf16 output gradient
    ``[bs][pad8(dout)]``. Two bf16 values take one f32 unit."""
    outs = list(dims[1:])
    shadows = sum(_pad(din * _pad(dout, 8) // 2, 4) for din, dout in zip(dims[:-1], outs))
    hidden = sum(_pad(bs * w, 4) + _pad(bs * _pad(w, 8) // 2, 4) for w in outs[:-1])
    logits = _pad(bs * outs[-1], 4)
    grads = sum(_pad(bs * _pad(w, 8) // 2, 4) for w in outs)
    return shadows + hidden + logits + grads


def epoch_flops(dims: Sequence[int], bs: int, n_batches: int, L: int) -> float:
    """The epoch's matrix-product FLOPs: forward and weight gradient of
    every layer, the activation gradient of every layer but the first."""
    macs = [a * b for a, b in zip(dims[:-1], dims[1:])]
    return 2.0 * bs * n_batches * L * (2 * sum(macs) + sum(macs[1:]))


def epoch_bytes(dims: Sequence[int], bs: int, n_batches: int, L: int,
                solver: str = "adam", every_step: bool = False) -> float:
    """Device-memory bytes of one epoch: the state read and written once
    plus the batch rows (bf16 features, f32 targets, f32 lane weights)
    read once. ``every_step``: as this design moves it, the state at every
    step and the bf16 shadow of every weight written at every step."""
    params = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    weights = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    state = 2 * 4 * (per_layer(solver) // 2) * params * L
    rows = n_batches * bs * (2 * dims[0] + 4 * dims[-1] + 4 * L)
    if every_step:
        return (state + 2 * weights * L) * n_batches + rows
    return state + rows


# ---------------------------------------------------------------------------
# plain PyTorch version (the Pallas kernel's body over a lane axis)
# ---------------------------------------------------------------------------


def activate(name: str, z: torch.Tensor) -> torch.Tensor:
    """A hidden layer's activation (``ACTIVATIONS``)."""
    if name == "relu":
        return torch.clamp_min(z, 0.0)
    if name == "tanh":
        return torch.tanh(z)
    if name == "logistic":
        return torch.sigmoid(z)
    return z


def _act_grad(name: str, z: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    if name == "relu":
        return (z > 0.0).float()
    if name == "tanh":
        return 1.0 - a * a
    if name == "logistic":
        return a * (1.0 - a)
    return torch.ones_like(a)


def epoch_reference(Xs, Ys, Wl, lr, alpha, t0: int, state: List[torch.Tensor], *,
                    dims: Sequence[int], act: str, bs: int, n_batches: int,
                    classification: bool, solver: str = "adam",
                    momentum: float = 0.9, nesterov: bool = True,
                    track_loss: bool = False) -> List[torch.Tensor]:
    """Plain version of ``epoch``, over every lane at once. Products round
    both operands to bf16 when ``Xs`` is bf16 and run in f32 otherwise;
    both accumulate in f32 (TF32 is off). Updates ``state`` in place and
    returns it."""
    bf16 = Xs.dtype == torch.bfloat16

    def rnd(x):
        return x.to(torch.bfloat16).float() if bf16 else x

    def mm(eq, a, b):
        return torch.einsum(eq, rnd(a), rnd(b))

    n_layers = len(dims) - 1
    k = per_layer(solver)
    lr3 = lr.float().reshape(-1, 1, 1)
    lr2 = lr3[:, :, 0]
    alpha = alpha.float().reshape(-1)
    f32 = torch.float32
    for step in range(n_batches):
        rows = slice(step * bs, (step + 1) * bs)
        xb = Xs[rows].float()
        yb = Ys[rows].float()  # [bs, c]
        wb = Wl[rows].float().T  # [L, bs]
        bw = torch.clamp(wb.sum(dim=1), min=1e-12)  # [L]
        t = torch.tensor(float(t0 + step + 1), dtype=f32, device=Xs.device)
        bc1 = 1.0 - torch.exp(t * _LOG_B1)
        bc2 = 1.0 - torch.exp(t * _LOG_B2)

        zs, acts = [], [xb]
        h = xb
        for li in range(n_layers):
            pW, pB = state[k * li], state[k * li + 1]
            eq = "bd,ldh->lbh" if li == 0 else "lbd,ldh->lbh"
            z = mm(eq, h, pW) + rnd(pB)[:, None, :]
            a = activate(act, z) if li < n_layers - 1 else z
            zs.append(z)
            acts.append(a)
            h = a

        scale = (wb / bw[:, None])[:, :, None]  # [L, bs, 1]
        out = acts[-1]
        if classification:
            p = torch.softmax(out, dim=-1)
            dz = (p - yb) * scale
        else:
            dz = (out - yb) * scale
        if track_loss:
            if classification:
                logp = torch.log(torch.clamp(p, min=1e-12))
                batch_loss = -torch.sum(yb * logp * wb[:, :, None], dim=(1, 2)) / bw
            else:
                batch_loss = 0.5 * torch.sum((out - yb) ** 2 * wb[:, :, None], dim=(1, 2)) / bw
            state[-1] += batch_loss

        coef = (alpha / bw)[:, None, None]
        for li in range(n_layers - 1, -1, -1):
            slabs = state[k * li: k * (li + 1)]
            pW, pB = slabs[0], slabs[1]
            eq = "bd,lbh->ldh" if li == 0 else "lbd,lbh->ldh"
            gW = mm(eq, acts[li], dz) + coef * pW
            gB = rnd(dz).sum(dim=1)  # [L, dout]
            if li > 0:
                da = mm("lbh,ldh->lbd", dz, pW)
                dz = da * _act_grad(act, zs[li - 1], acts[li])
            if solver == "adam":
                _, _, mW, mB, vW, vB = slabs
                for p_, m_, v_, g in ((pW, mW, vW, gW), (pB, mB, vB, gB)):
                    m_.mul_(B1).add_((1.0 - B1) * g)
                    v_.mul_(B2).add_((1.0 - B2) * g * g)
                    lr_ = lr3 if p_.dim() == 3 else lr2
                    p_.sub_(lr_ * (m_ / bc1) / (torch.sqrt(v_ / bc2) + EPS))
            else:
                _, _, velW, velB = slabs
                for p_, vel, g in ((pW, velW, gW), (pB, velB, gB)):
                    lr_ = lr3 if p_.dim() == 3 else lr2
                    vel.mul_(momentum).sub_(lr_ * g)
                    if nesterov:
                        p_.add_(momentum * vel - lr_ * g)
                    else:
                        p_.add_(vel)
    return state


# ---------------------------------------------------------------------------
# state carried across from the JAX package
# ---------------------------------------------------------------------------


def params_from_jax(np_params, device="cpu") -> List[dict]:
    """The JAX MLP ``params`` (a list of ``{"W": [din, dout], "b":
    [dout]}``, as numpy) as f32 tensors of the same layout."""
    return [{k: torch.as_tensor(np.array(layer[k], np.float32), device=device)
             for k in ("W", "b")} for layer in np_params]


def state_from_jax(np_state, solver: str = "adam", track_loss: bool = False,
                   device="cpu") -> List[torch.Tensor]:
    """The JAX fused state list (per layer ``(pW, pB, mW, mB, vW, vB)`` or
    ``(pW, pB, velW, velB)``, biases as ``[L, 8, dout]`` row-identical
    slabs, and with ``track_loss`` a trailing ``[L, 8, 128]`` loss slab)
    as the port's: biases ``[L, dout]`` (row 0), the loss ``[L]``."""
    k = per_layer(solver)
    n_layer_tensors = len(np_state) - (1 if track_loss else 0)
    out = []
    for i in range(n_layer_tensors):
        a = np.array(np_state[i], np.float32)
        if i % 2 == 1:  # biases and their moments
            a = np.ascontiguousarray(a[:, 0, :])
        out.append(torch.as_tensor(a, device=device))
    if n_layer_tensors % k:
        raise ValueError(f"{n_layer_tensors} layer tensors for solver {solver!r}")
    if track_loss:
        out.append(torch.as_tensor(np.array(np_state[-1], np.float32)[:, 0, 0].copy(),
                                   device=device))
    return out


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """The built csrc/mlp.cu with its C signatures declared."""
    global _lib_handle
    if _lib_handle is None:
        from .cuda_build import load

        lib = load("mlp")
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mlp_epoch.argtypes = [P] * 5 + [I, P, P, P, P, I, I, I, I, I, I, I, F, I, I, P]
        lib.mlp_epoch.restype = I
        lib.mlp_scratch_floats.argtypes = [P, I, I]
        lib.mlp_scratch_floats.restype = ctypes.c_longlong
        _lib_handle = lib
    return _lib_handle


def _on_card(*tensors) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie
    on the CPU; anything else is a caller error."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors span several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _dims_array(dims: Sequence[int]):
    padded = list(dims) + [0] * (MAX_LAYERS + 1 - len(dims))
    return (ctypes.c_int * (MAX_LAYERS + 1))(*padded)


def epoch(Xs, Ys, Wl, lr, alpha, t0: int, state: List[torch.Tensor], *,
          dims: Sequence[int], act: str, bs: int, n_batches: int,
          classification: bool, solver: str = "adam", momentum: float = 0.9,
          nesterov: bool = True, track_loss: bool = False) -> List[torch.Tensor]:
    """One Adam/SGD minibatch epoch for every lane, state updated in place.

    Xs [n_batches*bs, d] bf16 (CPU: bf16 or f32, the operand precision)
    Ys [n_batches*bs, c] f32: one-hot classes, or regression targets (c 1)
    Wl [n_batches*bs, L] f32: the lanes' split weights in the shuffled row
       order (0 for padded slots)
    lr, alpha [L] f32; t0: steps completed before this epoch
    state: the per-layer list (module docstring), plus loss [L] with
       ``track_loss``
    Returns ``state``.
    """
    kwargs = dict(dims=dims, act=act, bs=bs, n_batches=n_batches,
                  classification=classification, solver=solver,
                  momentum=momentum, nesterov=nesterov, track_loss=track_loss)
    if not _on_card(Xs, Ys, Wl, lr, alpha, *state):
        return epoch_reference(Xs, Ys, Wl, lr, alpha, t0, state, **kwargs)
    n_layers = len(dims) - 1
    L = lr.shape[0]
    R = n_batches * bs
    k = per_layer(solver)
    if not 1 <= n_layers <= MAX_LAYERS or act not in ACTIVATIONS or solver not in ("adam", "sgd"):
        raise ValueError(f"epoch: no kernel for dims={tuple(dims)}, act={act!r}, "
                         f"solver={solver!r}")
    if len(state) != k * n_layers + (1 if track_loss else 0):
        raise ValueError(f"epoch: {len(state)} state tensors for {n_layers} layers")
    _check("Xs", Xs, torch.bfloat16, (R, dims[0]))
    _check("Ys", Ys, torch.float32, (R, dims[-1]))
    _check("Wl", Wl, torch.float32, (R, L))
    _check("lr", lr, torch.float32, (L,))
    _check("alpha", alpha, torch.float32, (L,))
    ptrs = (ctypes.c_void_p * (6 * MAX_LAYERS))()
    for li in range(n_layers):
        din, dout = dims[li], dims[li + 1]
        for j in range(k):
            x = state[k * li + j]
            _check(f"state[{k * li + j}]", x, torch.float32,
                   (L, din, dout) if j % 2 == 0 else (L, dout))
            ptrs[6 * li + j] = x.data_ptr()
    loss = state[-1] if track_loss else None
    if loss is not None:
        _check("loss", loss, torch.float32, (L,))
    d_arr = _dims_array(dims)
    scratch = torch.empty((L, scratch_floats(dims, bs)), dtype=torch.float32,
                          device=Xs.device)
    with torch.cuda.device(Xs.device):
        stream = torch.cuda.current_stream(Xs.device).cuda_stream
        err = _lib().mlp_epoch(
            Xs.data_ptr(), Ys.data_ptr(), Wl.data_ptr(), lr.data_ptr(),
            alpha.data_ptr(), int(t0), ptrs,
            loss.data_ptr() if loss is not None else None, scratch.data_ptr(),
            d_arr, n_layers, bs, n_batches, L, ACTIVATIONS.index(act),
            int(classification), int(solver == "sgd"), float(momentum),
            int(nesterov), int(track_loss), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"mlp_epoch failed: CUDA error {err}")
    LAUNCHES["mlp_epoch"] += 1
    return state


def epoch_state(params: List[dict], L: int, solver: str = "adam",
                track_loss: bool = False) -> List[torch.Tensor]:
    """The initial state of L lanes that all start from ``params`` (a list
    of ``{"W", "b"}``): the params replicated, the moments or velocities
    zero, the loss zero."""
    out = []
    for layer in params:
        for leaf in (layer["W"], layer["b"]):
            out.append(leaf[None].repeat((L,) + (1,) * leaf.dim()).contiguous())
        for _ in range(per_layer(solver) // 2 - 1):
            for leaf in (layer["W"], layer["b"]):
                out.append(torch.zeros((L,) + tuple(leaf.shape), dtype=torch.float32,
                                       device=leaf.device))
    if track_loss:
        out.append(torch.zeros((L,), dtype=torch.float32, device=params[0]["W"].device))
    return out
