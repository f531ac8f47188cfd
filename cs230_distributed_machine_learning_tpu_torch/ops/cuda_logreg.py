"""Fused softmax-regression gradients: hand-written CUDA kernels for Hopper.

Counterpart of the JAX package's ``ops/pallas_logreg.py``. Three kernels,
in ``csrc/logreg.cu``, each beside its plain PyTorch version:

- ``packed_softmax_grad`` (replaces ``pallas_logreg.py:109``)
      G3[wb] = A^T (w * (softmax_c(A W3[wb]) - Y)) for every packed column;
- ``packed_nesterov_step`` (replaces ``pallas_logreg.py:228``)
      one whole Nesterov iteration of the packed fit, W / Wp updated in place;
- ``masked_softmax_grad`` (replaces ``pallas_logreg.py:372``)
      G[l] = A^T (wm[:, l] * (softmax(A W[l]) - Y)) for a batch of lanes.

The first two are one kernel body with two epilogues (``step_geometry``
picks its tile) and compute the same gradient to the bit. The masked kernel
runs in two passes, logits and bf16 residual, then the Gram product over P
row ranges (``masked_plan``), with no cap on the features.

Packing (the JAX package's): all trials' weight columns live in one
``[n_wb, dpp, NB]`` tensor per 128-trial block, class-major,
``col = (a * S + s) * Tw + t`` (a = class, s = split, t = trial in block),
``NB = c * S * Tw``.

Dispatch. A wrapper given CPU tensors computes its plain version; given
CUDA tensors it launches the kernel or raises. Nothing falls back from the
card to the plain version. Each wrapper counts its kernel launches in
``LAUNCHES`` so a run can show that it went through the kernels.

Bounds (H100 SXM, 989 TFLOP/s bf16, 3.35 TB/s) at the covertype main-path
shape, n_pad = 116,736, dpp = 64, c = 7, S = 6: the two products of the
packed kernels are 4 * n_pad * dpp * NB = 160.7 GFLOP per 128-trial block
per step (0.16 ms); 1.285 TFLOP (1.30 ms) for a 1024-trial step; about
257 TFLOP (0.26 s) for the 200-step job. Their device-memory traffic, the
bf16 A (15 MB) plus the f32 W / Wp (44 MB at 1024 trials), is ~18 us per
step: they are compute-bound. The masked kernel at the 784-feature
search's 16 lanes (n 4,096, dpp 896, 10 classes) is bound by its bytes;
at a full-size search's 192 lanes (n_pad 60,160) by its products over the
real classes, 0.42 ms.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

#: trials per packed weight block; the block width is ``c * S * TRIAL_BLOCK``
TRIAL_BLOCK = 128
#: the packed kernels take rows of A in multiples of this
PACKED_ROWS = 64
#: dynamic shared memory one CTA may use on Hopper
SMEM_LIMIT = 232_448

#: kernel launches per wrapper, for showing which kernels a run used
LAUNCHES = {
    "packed_softmax_grad": 0,
    "packed_nesterov_step": 0,
    "masked_softmax_grad": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# geometry gates (pure shape arithmetic: CPU and card route identically)
# ---------------------------------------------------------------------------


def _align(x: int, a: int = 128) -> int:
    return (x + a - 1) // a * a


def _ld_f32(cols: int) -> int:
    return cols + (40 - cols % 32) % 32


# The packed path's routing rule. The first (mma.sync) packed kernels held
# L = 16 or 32 lanes of c classes a CTA, at most 16 classes, 128 m16n8
# gradient tiles of 8 warps in registers, and this much shared memory;
# the packed path keeps exactly the shapes they took, so that no search
# moves between it and the generic drivers (the kernels no longer use it).
LANE_TILES = (32, 16)
_MAX_PACKED_CLASSES = 16


def packed_smem_bytes(dpp: int, c: int, L: int) -> int:
    """Shared memory of one CTA of the first packed kernels (of the
    routing rule)."""
    CL = c * L
    off = _align(CL * (dpp + 8) * 2)                     # bf16 V^T
    for _ in range(2):
        off = _align(off + PACKED_ROWS * (dpp + 8) * 2)  # bf16 A tiles
    off = _align(off + CL * (PACKED_ROWS + 8) * 2)       # bf16 residual
    for _ in range(4):
        off = _align(off + PACKED_ROWS * 4)              # labels, split weights
    off = max(off, _align(dpp * _ld_f32(CL) * 4))        # gradient staging overlay
    return _align(off + 256 * 4)                         # max|G| partials


def packed_lane_tile(dpp: int, c: int) -> Optional[int]:
    """The routing rule's lane tile at (dpp, c): the largest of
    ``LANE_TILES`` whose gradient tiles and shared memory fit the first
    packed kernels' CTA, or None."""
    for L in LANE_TILES:
        if (dpp % 16 == 0 and c <= _MAX_PACKED_CLASSES
                and (dpp // 8) * (c * L // 16) <= 8 * 16
                and packed_smem_bytes(dpp, c, L) <= SMEM_LIMIT):
            return L
    return None


# B1 and B2 (one body) on Hopper: rows of A per tile (64 a consumer
# warpgroup), features per 128-byte swizzle atom, the ring's most stages,
# and a bound on the accumulator floats a consumer thread holds (the logits
# and a whole gradient: the 168 registers a thread has at 288 threads hold
# the main path's without spills)
STEP_ROWS = 128
_STEP_ATOM = 64
_STEP_MAX_STAGES = 4
_STEP_MAX_ACC = 192
_STEP_EPILOGUE_THREADS = 256
#: B2's lane tiles, largest first
STEP_LANE_TILES = (16, 8)
#: the (N1, L, MT) instantiations of B1 and B2 (``LOGREG_STEP_GEOMETRIES``
#: in csrc/logreg.cu): N1 = L * (c rounded up to a power of two) columns,
#: MT = ceil(dpp / 64) feature atoms
STEP_GEOMETRIES = frozenset([
    (32, 16, 1), (32, 16, 2), (32, 16, 3), (32, 16, 4), (32, 16, 5), (32, 16, 6),
    (32, 16, 7), (32, 16, 8), (32, 8, 6), (64, 16, 1), (64, 16, 2), (64, 16, 3),
    (64, 16, 4), (64, 16, 5), (64, 8, 3), (128, 16, 1), (128, 16, 2), (128, 8, 1),
    (128, 8, 2),
])


def step_layout(dpp: int, n1: int) -> dict:
    """B1's and B2's shared memory (``step_layout`` in csrc/logreg.cu, byte
    for byte): V^T, two residual buffers of a tile's two halves, the ring
    of row-tile stages (as many as fit, up to 4), the mbarriers and the
    max|G| partials, the gradient staged over the first three at the end,
    and 1 KB to align the base."""
    mt = -(-dpp // _STEP_ATOM)
    off = mt * n1 * 128 + 4 * n1 * 128
    stage = _align(mt * STEP_ROWS * 128 + STEP_ROWS * 4, 1024)
    tail = 2 * _STEP_MAX_STAGES * 8 + _STEP_EPILOGUE_THREADS * 4 + 1024
    stages = min(_STEP_MAX_STAGES, max(0, SMEM_LIMIT - off - tail) // stage)
    off = max(off + stages * stage, _align(dpp * _ld_f32(n1) * 4))
    off = _align(off + 2 * _STEP_MAX_STAGES * 8) + _STEP_EPILOGUE_THREADS * 4
    return {"stages": stages, "stage_bytes": stage, "total": off + 1024}


def step_geometry(dpp: int, c: int) -> Optional[dict]:
    """B1's and B2's geometry at (dpp, c), or None: the lane tile L (16,
    else 8), N1 = L * (c rounded up to a power of two) columns (at most
    128: one wgmma N), MT feature atoms, so that the logits and a whole
    gradient (N1 / 2 * (MT + 1) floats a thread) would fit the registers and
    a ring stage fits shared memory."""
    if dpp <= 0 or dpp % 16 or not 2 <= c <= _MAX_PACKED_CLASSES:
        return None
    maxc = 1 << (c - 1).bit_length()
    mt = -(-dpp // _STEP_ATOM)
    for L in STEP_LANE_TILES:
        n1 = L * maxc
        if n1 > 128 or n1 // 2 * (mt + 1) > _STEP_MAX_ACC:
            continue
        if (n1, L, mt) not in STEP_GEOMETRIES:
            continue
        lay = step_layout(dpp, n1)
        if lay["stages"] >= 1 and lay["total"] <= SMEM_LIMIT:
            return {"L": L, "n1": n1, "mt": mt, **lay}
    return None


def fused_step_applicable(dpp: int, c: int) -> bool:
    """Gate of the packed kernels (the TPU's VMEM gate,
    ``pallas_logreg.py:151``, has no meaning here): the routing rule
    (``packed_lane_tile``) takes the shape, and B1 / B2 have a geometry."""
    return packed_lane_tile(dpp, c) is not None and step_geometry(dpp, c) is not None


# B3 on Hopper (csrc/logreg.cu, ``masked_plan``): 128-row tiles, pass (b)'s
# 128 columns a CTA, at most 16 row ranges, classes padded to at most 256,
# the H100's SMs, pass (a)'s ring budget (two CTAs an SM) and the bytes of
# an R^T staging row and of a pass (b) stage
MASKED_ROWS = 128
_MASKED_COLS = 128
_MASKED_MAX_RANGES = 16
MASKED_MAX_CP = 256
_SMS = 132
_MASKED_BUDGET_A = SMEM_LIMIT // 2 - 2048
_MASKED_LDR = MASKED_ROWS + 8
_MASKED_STAGE_B = 2 * STEP_ROWS * 128 + 2 * 64 * _MASKED_COLS * 2
#: the (NA, CPP) instantiations of B3's pass (a) (``LOGREG_MASKED_GEOMETRIES``)
MASKED_GEOMETRIES = frozenset([
    (64, 16), (64, 32), (64, 64), (128, 16), (128, 32), (128, 64), (128, 128), (256, 256),
])


def masked_plan(n_pad: int, dpp: int, cp: int, n_lanes: int) -> Optional[dict]:
    """B3's plan (``masked_plan`` in csrc/logreg.cu, field for field), or
    None where the kernels refuse the shape. Columns of R are lane-major
    (lane * cpp + class, cpp = cp rounded up to a power of two); pass (a)
    takes ``na`` columns a CTA (64 when 128 would leave SMs idle), pass (b)
    128 features x 128 columns over one of ``ranges`` row ranges, the
    fewest whose waves of CTAs take the least time. ``scratch`` is the
    bytes of W^T, R^T and the range partials."""
    if (n_pad <= 0 or dpp <= 0 or dpp % 16 or cp <= 0 or cp % 16 or cp > MASKED_MAX_CP
            or n_lanes <= 0):
        return None
    cpp = 16
    while cpp < cp:
        cpp *= 2
    row_tiles = -(-n_pad // MASKED_ROWS)
    cols = _align(n_lanes * cpp, _MASKED_COLS)
    na = 2 * _MASKED_COLS if cpp > _MASKED_COLS else _MASKED_COLS
    if cpp <= 64 and row_tiles * (cols // _MASKED_COLS) < _SMS:
        na = 64
    mt = -(-dpp // _STEP_ATOM)
    fb = (mt + 1) // 2
    units = fb * (cols // _MASKED_COLS)
    best, best_waves = 1, -(-units // _SMS)
    for P in range(2, min(_MASKED_MAX_RANGES, row_tiles) + 1):
        waves = -(-units * P // _SMS)
        if waves * best < best_waves * P:
            best, best_waves = P, waves
    stage_a = STEP_ROWS * 128 + na * 128
    stages_a = min(_STEP_MAX_STAGES, _MASKED_BUDGET_A // stage_a)
    smem_a = 1024 + max(stages_a * stage_a, na * _MASKED_LDR * 2) + 1024
    stages_b = min(_STEP_MAX_STAGES, (SMEM_LIMIT - 2048) // _MASKED_STAGE_B)
    smem_b = 1024 + stages_b * _MASKED_STAGE_B + 1024
    rows_pad = row_tiles * MASKED_ROWS
    r_off = _align(cols * dpp * 2, 1024)
    part_off = r_off + _align(cols * rows_pad * 2, 1024)
    return {"cpp": cpp, "na": na, "row_tiles": row_tiles, "cols": cols, "mt": mt, "fb": fb,
            "ranges": best, "stages_a": stages_a, "stages_b": stages_b, "smem_a": smem_a,
            "smem_b": smem_b, "scratch": part_off + best * dpp * cols * 4,
            "r_offset": r_off, "part_offset": part_off}


#: the fields of ``logreg_masked_plan``'s output, in order
MASKED_PLAN_FIELDS = ("cpp", "na", "row_tiles", "cols", "mt", "fb", "ranges", "stages_a",
                      "stages_b", "smem_a", "smem_b", "scratch")


def masked_ranges(plan: dict, n_pad: int) -> list:
    """Pass (b)'s row ranges ``[(r0, r1), ...]`` in order: range p takes
    the 128-row tiles p T / P .. (p + 1) T / P - 1, clipped to n_pad."""
    T, P = plan["row_tiles"], plan["ranges"]
    return [(p * T // P * MASKED_ROWS, min(n_pad, (p + 1) * T // P * MASKED_ROWS))
            for p in range(P)]


def masked_grad_applicable(dpp: int, cp: int) -> bool:
    """Gate of the masked lane kernel: features tiled in both passes, so
    any dpp in 16s; classes padded to 16s, at most ``MASKED_MAX_CP``."""
    return dpp > 0 and dpp % 16 == 0 and cp > 0 and cp % 16 == 0 and cp <= MASKED_MAX_CP


# ---------------------------------------------------------------------------
# plain PyTorch versions (the JAX package's *_reference functions)
# ---------------------------------------------------------------------------


def packed_softmax_grad_reference(Ab, W3, y2, WSP, *, c: int, S: int,
                                  Tw: int = TRIAL_BLOCK):
    """Plain version of ``packed_softmax_grad``: bf16 operands upcast to
    f32, the residual kept in f32 (``pallas_logreg.py:426``)."""
    A = Ab.float()
    n_pad, dpp = A.shape
    n_wb, _, NB = W3.shape
    B = S * Tw
    y = y2.reshape(-1)
    onehot = (y[:, None] == torch.arange(c, device=y.device)).float()  # [n, c]
    wexp = WSP.float().repeat_interleave(Tw, dim=1)  # [n, B] split-major
    out = []
    for W in W3:
        logits = A @ W.float()  # [n, NB]
        P = torch.softmax(logits.view(n_pad, c, B), dim=1)
        R = (P - onehot[:, :, None]) * wexp[:, None, :]
        out.append(torch.einsum("nd,ncb->dcb", A, R).reshape(dpp, NB))
    return torch.stack(out)


def packed_nesterov_step_reference(Ab, W3, Wp3, y2, WSP, t, done, step_b, Cb,
                                   maxit_b, pen_col, *, c: int, S: int,
                                   Tw: int = TRIAL_BLOCK, lam: float = 0.0):
    """Plain version of ``packed_nesterov_step``: the legacy scan body's
    algebra on the packed layout (``pallas_logreg.py:303``). Returns new
    tensors ``(W_new, Wp_new, gmax)``."""
    n_wb, dpp, NB = W3.shape
    B = S * Tw
    t = torch.as_tensor(t, dtype=torch.float32, device=W3.device)
    mom = t / (t + 3.0)
    V = W3 + mom * (W3 - Wp3)
    Graw = packed_softmax_grad_reference(
        Ab, V.to(torch.bfloat16), y2, WSP, c=c, S=S, Tw=Tw
    )
    cb_full = Cb.repeat(1, c)[:, None, :]  # [n_wb, 1, NB]
    step_full = step_b.repeat(1, c)[:, None, :]
    pen_row = pen_col.reshape(1, dpp, 1)
    G = cb_full * Graw + lam * pen_row * V
    gmax = G.abs().reshape(n_wb, dpp, c, B).amax(dim=(1, 2))
    active = (t < maxit_b) & (done == 0.0)
    act = active.repeat(1, c)[:, None, :]
    W_new = torch.where(act, V - step_full * G, W3)
    Wp_new = torch.where(act, W3, Wp3)
    return W_new, Wp_new, gmax


def masked_softmax_grad_reference(Ab, W, y2, wm, *, c: int):
    """Plain version of ``masked_softmax_grad`` over a lane batch, in the
    fused-mask form of ``pallas_logreg.py:404``:
    ``w * softmax(z) == exp(z - max) * (w / den)``."""
    A = Ab.float()
    cp = W.shape[-1]
    Z = torch.einsum("nd,ldc->lnc", A, W.float())  # [L, n, cp]
    col = torch.arange(cp, device=A.device)
    Z = torch.where(col < c, Z, torch.full_like(Z, -1e30))
    e = torch.exp(Z - Z.amax(dim=-1, keepdim=True))
    wl = wm.float().T[:, :, None]  # [L, n, 1]
    Pw = e * (wl / e.sum(dim=-1, keepdim=True))
    WY = torch.where(y2.reshape(1, -1, 1) == col, wl, torch.zeros_like(wl))
    return torch.einsum("nd,lnc->ldc", A, Pw - WY)


def masked_softmax_grad_two_pass(Ab, W, y2, wm, *, c: int):
    """The masked kernel's two passes in plain PyTorch, at its rounding
    points and in its sum order over the row ranges: f32 logits of the
    lane-major columns (classes padded to ``cpp``, past c at -inf), the
    softmax's weighted residual rounded to bf16 (pass a), then the Gram
    product of each of ``masked_plan``'s row ranges in f32, the partials
    added in range order (pass b; the order of the sums inside a range is
    the einsum's). Returns G [L, dpp, cp], columns >= c exactly zero."""
    n_pad, dpp = Ab.shape
    n_lanes, _, cp = W.shape
    plan = masked_plan(n_pad, dpp, cp, n_lanes)
    if plan is None or not 2 <= c <= cp:
        raise ValueError(f"masked_softmax_grad: no plan for dpp={dpp}, cp={cp}, c={c}")
    cpp = plan["cpp"]
    A = Ab.float()
    Wp = torch.nn.functional.pad(W.float(), (0, cpp - cp))
    Z = torch.einsum("nd,ldc->nlc", A, Wp)  # [n, L, cpp]
    col = torch.arange(cpp, device=A.device)
    Z = torch.where(col < c, Z, torch.full_like(Z, float("-inf")))
    e = torch.exp(Z - Z.amax(dim=-1, keepdim=True))
    onehot = (y2.reshape(-1, 1, 1) == col).float()
    R = ((e * (1.0 / e.sum(dim=-1, keepdim=True)) - onehot) * wm.float()[:, :, None])
    R = R.to(torch.bfloat16).float()
    G = None
    for r0, r1 in masked_ranges(plan, n_pad):
        part = torch.einsum("nd,nlc->ldc", A[r0:r1], R[r0:r1])
        G = part if G is None else G + part
    G[:, :, c:] = 0.0
    return G[:, :, :cp].contiguous()


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """The built csrc/logreg.cu with its C signatures declared."""
    global _lib_handle
    if _lib_handle is None:
        from .cuda_build import load

        lib = load("logreg")
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.logreg_packed_softmax_grad.argtypes = [P] * 5 + [I] * 8 + [P]
        lib.logreg_packed_softmax_grad.restype = I
        lib.logreg_packed_nesterov_step.argtypes = (
            [P] * 5 + [F] + [P] * 6 + [F] + [I] * 8 + [P]
        )
        lib.logreg_packed_nesterov_step.restype = I
        lib.logreg_step_smem_bytes.argtypes = [I, I]
        lib.logreg_step_smem_bytes.restype = ctypes.c_longlong
        lib.logreg_step_stages.argtypes = [I, I]
        lib.logreg_step_stages.restype = I
        lib.logreg_step_geometry_ok.argtypes = [I, I, I]
        lib.logreg_step_geometry_ok.restype = I
        lib.logreg_masked_plan.argtypes = [I, I, I, I, P]
        lib.logreg_masked_plan.restype = I
        lib.logreg_masked_softmax_grad.argtypes = (
            [P] * 6 + [ctypes.c_longlong] + [I] * 6 + [P]
        )
        lib.logreg_masked_softmax_grad.restype = I
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
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def _launch(fn, *args, device: torch.device) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def packed_softmax_grad(Ab, W3, y2, WSP, *, c: int, S: int, Tw: int = TRIAL_BLOCK):
    """G3[wb] = A^T (w * (softmax(A W3[wb]) - Y)) for every packed column.

    Ab  [n_pad, dpp]     bf16 (pad rows carry zero split weight)
    W3  [n_wb, dpp, NB]  bf16, NB == c*S*Tw, column = (a*S + s)*Tw + t
    y2  [n_pad, 1]       i32
    WSP [n_pad, S]       f32
    returns G3 [n_wb, dpp, NB] f32
    """
    if not _on_card(Ab, W3, y2, WSP):
        return packed_softmax_grad_reference(Ab, W3, y2, WSP, c=c, S=S, Tw=Tw)
    n_pad, dpp = Ab.shape
    n_wb, NB = W3.shape[0], c * S * Tw
    _check("Ab", Ab, torch.bfloat16, (n_pad, dpp))
    _check("W3", W3, torch.bfloat16, (n_wb, dpp, NB))
    _check("y2", y2, torch.int32, (n_pad, 1))
    _check("WSP", WSP, torch.float32, (n_pad, S))
    geo = step_geometry(dpp, c)
    if geo is None or n_pad % PACKED_ROWS or Tw % geo["L"]:
        raise ValueError(
            f"packed_softmax_grad: no kernel geometry for n_pad={n_pad}, "
            f"dpp={dpp}, c={c}"
        )
    G3 = torch.empty((n_wb, dpp, NB), dtype=torch.float32, device=Ab.device)
    with torch.cuda.device(Ab.device):
        _launch(_lib().logreg_packed_softmax_grad, _ptr(Ab), _ptr(W3), _ptr(y2),
                _ptr(WSP), _ptr(G3), n_pad, dpp, n_wb, S, Tw, c, geo["L"], geo["n1"],
                device=Ab.device)
    LAUNCHES["packed_softmax_grad"] += 1
    return G3


def packed_nesterov_step(Ab, W3, Wp3, y2, WSP, t, done, step_b, Cb, maxit_b,
                         pen_col, *, c: int, S: int, Tw: int = TRIAL_BLOCK,
                         lam: float = 0.0):
    """ONE full Nesterov iteration of the packed LogReg fit, fused: the
    look-ahead ``V = W + t/(t+3) (W - Wp)``, the masked softmax-Gram
    gradient at bf16 V, ``G = C * Graw + lam * pen * V``, the per-(split,
    trial) ``max|G|``, and the done / max_iter-masked writeback.

    Ab [n_pad, dpp] bf16; W3, Wp3 [n_wb, dpp, NB] f32; y2 [n_pad, 1] i32;
    WSP [n_pad, S] f32; t python float (iteration index); done, step_b, Cb,
    maxit_b [n_wb, B] f32 with B = S*Tw; pen_col [dpp, 1] f32.

    W3 and Wp3 are UPDATED IN PLACE (on both devices) and returned with
    ``gmax [n_wb, B] f32``: ``(W3, Wp3, gmax)``.
    """
    if not _on_card(Ab, W3, Wp3, y2, WSP, done, step_b, Cb, maxit_b, pen_col):
        W_new, Wp_new, gmax = packed_nesterov_step_reference(
            Ab, W3, Wp3, y2, WSP, t, done, step_b, Cb, maxit_b, pen_col,
            c=c, S=S, Tw=Tw, lam=lam,
        )
        W3.copy_(W_new)
        Wp3.copy_(Wp_new)
        return W3, Wp3, gmax
    n_pad, dpp = Ab.shape
    n_wb, B = W3.shape[0], S * Tw
    _check("Ab", Ab, torch.bfloat16, (n_pad, dpp))
    _check("W3", W3, torch.float32, (n_wb, dpp, c * B))
    _check("Wp3", Wp3, torch.float32, (n_wb, dpp, c * B))
    _check("y2", y2, torch.int32, (n_pad, 1))
    _check("WSP", WSP, torch.float32, (n_pad, S))
    for name, x in (("done", done), ("step_b", step_b), ("Cb", Cb),
                    ("maxit_b", maxit_b)):
        _check(name, x, torch.float32, (n_wb, B))
    _check("pen_col", pen_col, torch.float32, (dpp, 1))
    geo = step_geometry(dpp, c)
    if geo is None or n_pad % PACKED_ROWS or Tw % geo["L"]:
        raise ValueError(
            f"packed_nesterov_step: no kernel geometry for n_pad={n_pad}, "
            f"dpp={dpp}, c={c}"
        )
    gmax = torch.empty((n_wb, B), dtype=torch.float32, device=Ab.device)
    with torch.cuda.device(Ab.device):
        _launch(_lib().logreg_packed_nesterov_step, _ptr(Ab), _ptr(W3),
                _ptr(Wp3), _ptr(y2), _ptr(WSP), float(t), _ptr(done),
                _ptr(step_b), _ptr(Cb), _ptr(maxit_b), _ptr(pen_col),
                _ptr(gmax), float(lam), n_pad, dpp, n_wb, S, Tw, c, geo["L"],
                geo["n1"], device=Ab.device)
    LAUNCHES["packed_nesterov_step"] += 1
    return W3, Wp3, gmax


def masked_softmax_grad(Ab, W, y2, wm, *, c: int):
    """G[l] = A^T (wm[:, l] * (softmax(A W[l]) - Y)) for a batch of lanes.

    Ab [n_pad, dpp] bf16 (shared by every lane, never replicated); W [L,
    dpp, cp] bf16, classes zero-padded to cp (columns >= c ignored); y2
    [n_pad, 1] i32; wm [n_pad, L] f32 per-lane sample weights. Returns
    G [L, dpp, cp] f32 with columns >= c exactly zero. On the card: the
    two passes of ``masked_plan`` in one C call, on a scratch buffer of the
    plan's size (W^T, the bf16 residual R^T, the row ranges' partials).
    """
    if not _on_card(Ab, W, y2, wm):
        return masked_softmax_grad_reference(Ab, W, y2, wm, c=c)
    n_pad, dpp = Ab.shape
    n_lanes, cp = W.shape[0], W.shape[2]
    _check("Ab", Ab, torch.bfloat16, (n_pad, dpp))
    _check("W", W, torch.bfloat16, (n_lanes, dpp, cp))
    _check("y2", y2, torch.int32, (n_pad, 1))
    _check("wm", wm, torch.float32, (n_pad, n_lanes))
    plan = masked_plan(n_pad, dpp, cp, n_lanes)
    if plan is None or not 2 <= c <= cp:
        raise ValueError(
            f"masked_softmax_grad: no kernel geometry for n_pad={n_pad}, "
            f"dpp={dpp}, cp={cp}, c={c}"
        )
    G = torch.empty((n_lanes, dpp, cp), dtype=torch.float32, device=Ab.device)
    scratch = torch.empty(plan["scratch"], dtype=torch.uint8, device=Ab.device)
    with torch.cuda.device(Ab.device):
        _launch(_lib().logreg_masked_softmax_grad, _ptr(Ab), _ptr(W), _ptr(y2),
                _ptr(wm), _ptr(G), _ptr(scratch), plan["scratch"], n_pad, dpp, cp, c,
                n_lanes, plan["ranges"], device=Ab.device)
    LAUNCHES["masked_softmax_grad"] += 1
    return G


# ---------------------------------------------------------------------------
# weights carried across from the JAX package / between layouts
# ---------------------------------------------------------------------------


def weights_from_jax(np_params, device="cpu") -> torch.Tensor:
    """The JAX LogReg ``params`` (``W [dp, c]`` f32, as numpy) as the
    port's f32 tensor of the same layout."""
    return torch.as_tensor(np.asarray(np_params, np.float32), device=device).clone()


def pack_weights(W: torch.Tensor, dpp: int, Tw: int = TRIAL_BLOCK) -> torch.Tensor:
    """``[chunk, S, dp, c]`` per-lane weights -> the packed class-major
    ``[n_wb, dpp, NB]`` layout (chunk % Tw == 0; rows >= dp are zero)."""
    chunk, S, dp, c = W.shape
    if chunk % Tw:
        raise ValueError(f"chunk {chunk} is not a multiple of {Tw}")
    n_wb = chunk // Tw
    full = W.new_zeros((chunk, S, dpp, c))
    full[:, :, :dp] = W
    # [n_wb, Tw, S, dpp, c] -> [n_wb, dpp, c, S, Tw]
    packed = full.reshape(n_wb, Tw, S, dpp, c).permute(0, 3, 4, 2, 1)
    return packed.reshape(n_wb, dpp, c * S * Tw).contiguous()


def unpack_weights(W3: torch.Tensor, S: int, dp: int, c: int,
                   Tw: int = TRIAL_BLOCK) -> torch.Tensor:
    """Inverse of ``pack_weights``: ``[n_wb, dpp, NB]`` -> ``[chunk, S,
    dp, c]``."""
    n_wb, dpp, _ = W3.shape
    lanes = W3.reshape(n_wb, dpp, c, S, Tw).permute(0, 4, 3, 1, 2)
    return lanes.reshape(n_wb * Tw, S, dpp, c)[:, :, :dp].contiguous()
