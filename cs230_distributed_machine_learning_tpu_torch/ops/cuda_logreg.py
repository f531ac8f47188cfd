"""Fused softmax-regression gradients: hand-written CUDA kernels for Hopper.

Counterpart of the JAX package's ``ops/pallas_logreg.py``. Three kernels,
in ``csrc/logreg.cu``, each beside its plain PyTorch version:

- ``packed_softmax_grad`` (replaces ``pallas_logreg.py:109``)
      G3[wb] = A^T (w * (softmax_c(A W3[wb]) - Y)) for every packed column;
- ``packed_nesterov_step`` (replaces ``pallas_logreg.py:228``)
      one whole Nesterov iteration of the packed fit, W / Wp updated in place;
- ``masked_softmax_grad`` (replaces ``pallas_logreg.py:372``)
      G[l] = A^T (wm[:, l] * (softmax(A W[l]) - Y)) for a batch of lanes.

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
step: they are compute-bound. The masked kernel's products over the c
real classes are small beside its bytes at a few lanes: at the 784-feature
search's 16 lanes (n 4,096, dpp 896, 10 classes) its bytes bound it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

#: trials per packed weight block; the block width is ``c * S * TRIAL_BLOCK``
TRIAL_BLOCK = 128
#: rows of A per tile in the packed (B1/B2) and masked (B3) kernels
PACKED_ROWS = 64
MASKED_ROWS = 32
#: lanes per CTA the packed kernels can take, largest first
LANE_TILES = (32, 16)

# the kernels' fixed launch shape (csrc/logreg.cu): 8 warps; the packed
# kernels keep at most 16 m16n8 gradient tiles (f32) in each warp's
# registers and are built for up to 16 classes, the masked kernel at most 8
# WMMA accumulator tiles of 16 x 16
_THREADS = 256
_MAX_PACKED_TILES = 8 * 16
_MAX_PACKED_CLASSES = 16
_MAX_MASKED_TILES = 8 * 8
#: dynamic shared memory one CTA may use on Hopper
SMEM_LIMIT = 232_448
#: CTAs that keep two resident on each of an H100's 132 SMs
_FILL_CTAS = 264

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


def _ld_bf16(cols: int) -> int:
    return cols + 8


def _ld_f32(cols: int) -> int:
    return cols + (40 - cols % 32) % 32


def packed_smem_bytes(dpp: int, c: int, L: int) -> int:
    """Dynamic shared memory of one packed CTA (``packed_layout`` in
    csrc/logreg.cu, byte for byte)."""
    CL = c * L
    off = _align(CL * _ld_bf16(dpp) * 2)                    # bf16 V^T
    for _ in range(2):
        off = _align(off + PACKED_ROWS * _ld_bf16(dpp) * 2)  # bf16 A tiles
    off = _align(off + CL * _ld_bf16(PACKED_ROWS) * 2)      # bf16 residual
    for _ in range(4):
        off = _align(off + PACKED_ROWS * 4)                 # labels, split weights
    off = max(off, _align(dpp * _ld_f32(CL) * 4))           # gradient staging overlay
    return _align(off + _THREADS * 4)                       # max|G| partials


def masked_smem_bytes(dpp: int, cp: int) -> int:
    """Dynamic shared memory of one masked CTA (``masked_layout``)."""
    off = _align(dpp * _ld_bf16(cp) * 2)
    for _ in range(2):
        off = _align(off + MASKED_ROWS * _ld_bf16(dpp) * 2)
    off = _align(off + 8 * MASKED_ROWS * _ld_f32(cp) * 4)
    off = _align(off + MASKED_ROWS * _ld_f32(cp) * 4)
    off = _align(off + MASKED_ROWS * _ld_bf16(cp) * 2)
    for _ in range(4):
        off = _align(off + MASKED_ROWS * 4)
    return off


def _packed_fits(dpp: int, c: int, L: int) -> bool:
    return (
        dpp % 16 == 0
        and c <= _MAX_PACKED_CLASSES
        and (dpp // 8) * (c * L // 16) <= _MAX_PACKED_TILES
        and packed_smem_bytes(dpp, c, L) <= SMEM_LIMIT
    )


def packed_lane_tile(dpp: int, c: int, n_wb: int = 1, S: int = 1,
                     Tw: int = TRIAL_BLOCK) -> Optional[int]:
    """Lanes per CTA for the packed kernels, or None when no lane tile fits
    a CTA's registers and shared memory. Among the tiles that fit, the
    largest whose grid still keeps two CTAs on every SM; else the smallest
    (the most CTAs)."""
    fits = [L for L in LANE_TILES if Tw % L == 0 and _packed_fits(dpp, c, L)]
    if not fits:
        return None
    for L in fits:
        if n_wb * S * Tw // L >= _FILL_CTAS:
            return L
    return fits[-1]


# B2 (the fused step) on Hopper: rows of A per tile (64 a consumer
# warpgroup), features per 128-byte swizzle atom, the ring's most stages,
# and a bound on the accumulator floats a consumer thread holds (the logits
# and a whole gradient: the 168 registers a thread has at 288 threads hold
# the main path's without spills)
STEP_ROWS = 128
_STEP_ATOM = 64
_STEP_MAX_STAGES = 4
_STEP_MAX_ACC = 192
#: B2's lane tiles, largest first
STEP_LANE_TILES = (16, 8)
#: the (N1, L, MT) instantiations of B2 (``LOGREG_STEP_GEOMETRIES`` in
#: csrc/logreg.cu): N1 = L * (c rounded up to a power of two) columns,
#: MT = ceil(dpp / 64) feature atoms
STEP_GEOMETRIES = frozenset([
    (32, 16, 1), (32, 16, 2), (32, 16, 3), (32, 16, 4), (32, 16, 5), (32, 16, 6),
    (32, 16, 7), (32, 16, 8), (32, 8, 6), (64, 16, 1), (64, 16, 2), (64, 16, 3),
    (64, 16, 4), (64, 16, 5), (64, 8, 3), (128, 16, 1), (128, 16, 2), (128, 8, 1),
    (128, 8, 2),
])


def step_layout(dpp: int, n1: int) -> dict:
    """B2's shared memory (``step_layout`` in csrc/logreg.cu, byte for byte):
    V^T, two residual buffers of a tile's two halves, the ring of row-tile
    stages (as many as fit, up to 4), the mbarriers and the max|G|
    partials, the gradient staged over the first three at the end, and 1 KB
    to align the base."""
    mt = -(-dpp // _STEP_ATOM)
    off = mt * n1 * 128 + 4 * n1 * 128
    stage = _align(mt * STEP_ROWS * 128 + STEP_ROWS * 4, 1024)
    tail = 2 * _STEP_MAX_STAGES * 8 + _THREADS * 4 + 1024
    stages = min(_STEP_MAX_STAGES, max(0, SMEM_LIMIT - off - tail) // stage)
    off = max(off + stages * stage, _align(dpp * _ld_f32(n1) * 4))
    off = _align(off + 2 * _STEP_MAX_STAGES * 8) + _THREADS * 4
    return {"stages": stages, "stage_bytes": stage, "total": off + 1024}


def step_geometry(dpp: int, c: int) -> Optional[dict]:
    """B2's geometry at (dpp, c), or None: the lane tile L (16, else 8),
    N1 = L * (c rounded up to a power of two) columns (at most 128: one
    wgmma N), MT feature atoms, so that the logits and a whole gradient
    (N1 / 2 * (MT + 1) floats a thread) would fit the registers and a ring
    stage fits shared memory."""
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
    ``pallas_logreg.py:151``, has no meaning here): a B1 lane tile fits,
    and B2 has a geometry."""
    return packed_lane_tile(dpp, c) is not None and step_geometry(dpp, c) is not None


def masked_grad_applicable(dpp: int, cp: int) -> bool:
    """Gate of the masked lane kernel: one lane's gradient fits the CTA's
    registers and its buffers fit shared memory."""
    return (
        dpp % 16 == 0 and cp % 16 == 0
        and (dpp // 16) * (cp // 16) <= _MAX_MASKED_TILES
        and masked_smem_bytes(dpp, cp) <= SMEM_LIMIT
    )


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
        lib.logreg_packed_softmax_grad.argtypes = [P] * 5 + [I] * 7 + [P]
        lib.logreg_packed_softmax_grad.restype = I
        lib.logreg_packed_nesterov_step.argtypes = (
            [P] * 5 + [F] + [P] * 6 + [F] + [I] * 8 + [P]
        )
        lib.logreg_step_smem_bytes.argtypes = [I, I]
        lib.logreg_step_smem_bytes.restype = ctypes.c_longlong
        lib.logreg_step_stages.argtypes = [I, I]
        lib.logreg_step_stages.restype = I
        lib.logreg_step_geometry_ok.argtypes = [I, I, I]
        lib.logreg_step_geometry_ok.restype = I
        lib.logreg_packed_nesterov_step.restype = I
        lib.logreg_masked_softmax_grad.argtypes = [P] * 5 + [I] * 5 + [P]
        lib.logreg_masked_softmax_grad.restype = I
        lib.logreg_packed_smem_bytes.argtypes = [I, I, I]
        lib.logreg_packed_smem_bytes.restype = ctypes.c_longlong
        lib.logreg_masked_smem_bytes.argtypes = [I, I]
        lib.logreg_masked_smem_bytes.restype = ctypes.c_longlong
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
    L = packed_lane_tile(dpp, c, n_wb, S, Tw)
    if L is None or n_pad % PACKED_ROWS:
        raise ValueError(
            f"packed_softmax_grad: no kernel geometry for n_pad={n_pad}, "
            f"dpp={dpp}, c={c}"
        )
    G3 = torch.empty((n_wb, dpp, NB), dtype=torch.float32, device=Ab.device)
    with torch.cuda.device(Ab.device):
        _launch(_lib().logreg_packed_softmax_grad, _ptr(Ab), _ptr(W3), _ptr(y2),
                _ptr(WSP), _ptr(G3), n_pad, dpp, n_wb, S, Tw, c, L,
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
    G [L, dpp, cp] f32 with columns >= c exactly zero.
    """
    if not _on_card(Ab, W, y2, wm):
        return masked_softmax_grad_reference(Ab, W, y2, wm, c=c)
    n_pad, dpp = Ab.shape
    n_lanes, cp = W.shape[0], W.shape[2]
    _check("Ab", Ab, torch.bfloat16, (n_pad, dpp))
    _check("W", W, torch.bfloat16, (n_lanes, dpp, cp))
    _check("y2", y2, torch.int32, (n_pad, 1))
    _check("wm", wm, torch.float32, (n_pad, n_lanes))
    if not masked_grad_applicable(dpp, cp) or n_pad % MASKED_ROWS or c > cp:
        raise ValueError(
            f"masked_softmax_grad: no kernel geometry for n_pad={n_pad}, "
            f"dpp={dpp}, cp={cp}, c={c}"
        )
    G = torch.empty((n_lanes, dpp, cp), dtype=torch.float32, device=Ab.device)
    with torch.cuda.device(Ab.device):
        _launch(_lib().logreg_masked_softmax_grad, _ptr(Ab), _ptr(W), _ptr(y2),
                _ptr(wm), _ptr(G), n_pad, dpp, cp, c, n_lanes,
                device=Ab.device)
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
