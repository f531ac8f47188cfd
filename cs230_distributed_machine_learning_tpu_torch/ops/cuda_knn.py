"""Fused k-nearest-neighbour search: a hand-written CUDA kernel for Hopper.

Counterpart of the JAX package's ``ops/pallas_knn.py``. One kernel, in
``csrc/knn.cu``, beside its plain PyTorch version:

- ``knn_topk`` (replaces ``pallas_knn.py:111``, ``knn_topk``): for every
  lane l and query q, the k smallest masked squared distances

      d2[l, q, j] = max((qsq[q] + tsq[j]) - 2 Q[q].Xt[j], 0),
                    3.4e38 where W[l, j] <= 0

  ascending by (d2, j), with their training-row indices.

The lane axis is explicit (one split mask a lane; the JAX package vmaps the
single-lane call over trials and splits instead). The ``[L, nq, n]``
distance matrix is never built: both versions stream training tiles.

Ties. A candidate enters a list only if it is strictly below the worst
kept distance, so among equal distances the lowest index is kept and
emitted first. The TPU kernel keeps the same set but emits equal distances
in slot order; the votes do not depend on that order. Slots no masked-in
row reaches stay ``(3.4e38, -1)``. The TPU kernel starts its slots so,
but its closing sort re-reads a retired slot for the empty ones, which
therefore carry the index held in its first slot (a difference recorded
in ROADMAP.md, C; it needs a lane with fewer than k masked-in rows).

Dispatch. Given CPU tensors the wrapper computes the plain version; given
CUDA tensors it launches the kernel or raises. Nothing falls back from the
card to the plain version. ``LAUNCHES`` counts kernel launches. The kernel
takes any k: up to ``SHARED_LISTS_MAX_K`` its per-query lists live in
shared memory, above it in device memory (the output tensors themselves,
kept as max-heaps and sorted at the end), by the same insertion rule and
with the same result; ``knn_list_mode`` says which.

Bounds (H100 SXM: 67 TFLOP/s f32, 3.35 TB/s): at the search path's launch
shape (4,096 queries, 200,000 training rows, d 54, 6 lanes) the distance
product, once for all lanes, is 8.85e10 f32 operations (1.32 ms); the
bytes, ~50 MB, take 0.015 ms. Operations bound it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

#: the largest k whose lists the kernel keeps in shared memory (csrc/knn.cu);
#: above it they live in device memory
SHARED_LISTS_MAX_K = 256
#: the distance value of a masked row and of an empty slot
INF = 3.4e38
#: training rows per merge in the plain version
_PLAIN_TILE = 4096

#: kernel launches, for showing that a run went through the kernel
LAUNCHES = {"knn_topk": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def knn_list_mode(k: int) -> str:
    """Where the kernel keeps its per-query lists at ``k``: ``"shared"``
    (shared memory, k <= ``SHARED_LISTS_MAX_K``) or ``"device"`` (device
    memory: the ``[L, nq, k]`` outputs, updated in place)."""
    if k < 1:
        raise ValueError(f"knn_list_mode: k={k} must be at least 1")
    return "shared" if k <= SHARED_LISTS_MAX_K else "device"


def smem_bytes(k: int) -> int:
    """Shared memory of one CTA at ``k`` (``smem_bytes`` in csrc/knn.cu):
    the transposed query and tile chunks, the distance tile, the tile's
    norms and weights, and the lists when they live in shared memory."""
    lists = 64 * k * 8 if knn_list_mode(k) == "shared" else 0
    return 4 * (64 * 68 + 64 * 132 + 64 * 132 + 64 + 2 * 128) + lists


def _sq_norms(Q: torch.Tensor, Xt: torch.Tensor):
    """Row sums of squares in f32 (``pallas_knn.py:127-128``), computed the
    same way for the kernel and its plain version."""
    return (Q * Q).sum(dim=1), (Xt * Xt).sum(dim=1)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def knn_topk_reference(Q, Xt, W, k: int, *, tile: int = _PLAIN_TILE):
    """Plain version of ``knn_topk``, same signature: stream training tiles
    and merge each into the running lists by a stable sort of ``[best,
    tile]`` (earlier entries first, so equal distances keep the lower
    index, and empty slots beat masked rows). Never builds ``[L, nq, n]``."""
    L, n = W.shape
    nq = Q.shape[0]
    dev = Q.device
    qsq, tsq = _sq_norms(Q, Xt)
    best_d = torch.full((L, nq, k), INF, dtype=torch.float32, device=dev)
    best_i = torch.full((L, nq, k), -1, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for j0 in range(0, n, tile):
        j1 = min(n, j0 + tile)
        d2 = (qsq[:, None] + tsq[None, j0:j1]) - 2.0 * (Q @ Xt[j0:j1].T)
        d2 = torch.maximum(d2, zero)
        d2 = torch.where(W[:, None, j0:j1] > 0, d2[None], INF)
        cols = torch.arange(j0, j1, dtype=torch.int32, device=dev).expand(L, nq, j1 - j0)
        cat_d = torch.cat([best_d, d2], dim=2)
        cat_i = torch.cat([best_i, cols], dim=2)
        sd, order = torch.sort(cat_d, dim=2, stable=True)
        best_d = sd[..., :k].contiguous()
        best_i = torch.gather(cat_i, 2, order[..., :k])
    return best_d, best_i


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """The built csrc/knn.cu with its C signatures declared."""
    global _lib_handle
    if _lib_handle is None:
        from .cuda_build import load

        lib = load("knn")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.knn_topk.argtypes = [P] * 7 + [I] * 5 + [P]
        lib.knn_topk.restype = I
        lib.knn_max_shared_k.argtypes = []
        lib.knn_max_shared_k.restype = I
        lib.knn_smem_bytes.argtypes = [I]
        lib.knn_smem_bytes.restype = ctypes.c_longlong
        _lib_handle = lib
    return _lib_handle


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def knn_topk(Q, Xt, W, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest masked training rows of every query, per lane.

    Q  [nq, d] f32 queries
    Xt [n, d]  f32 training rows, shared by the lanes
    W  [L, n]  f32 lane weights; rows with W <= 0 are excluded

    Returns ``(d2 [L, nq, k] f32 ascending, idx [L, nq, k] i32)``.
    """
    devs = {t.device for t in (Q, Xt, W)}
    if len(devs) != 1:
        raise ValueError(f"tensors span several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    k = int(k)
    if dev.type == "cpu":
        return knn_topk_reference(Q, Xt, W, k)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    nq, d = Q.shape
    L, n = W.shape
    _check("Q", Q, torch.float32, (nq, d))
    _check("Xt", Xt, torch.float32, (n, d))
    _check("W", W, torch.float32, (L, n))
    if k < 1:
        raise ValueError(f"knn_topk: k={k} must be at least 1")
    if nq == 0 or n == 0 or d == 0 or L == 0:
        raise ValueError(f"knn_topk: empty input (nq={nq}, n={n}, d={d}, L={L})")
    qsq, tsq = _sq_norms(Q, Xt)
    out_d = torch.empty((L, nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((L, nq, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().knn_topk(
            *(ctypes.c_void_p(t.data_ptr()) for t in (Q, Xt, qsq, tsq, W, out_d, out_i)),
            nq, n, d, L, k, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"knn_topk failed: CUDA error {err}")
    LAUNCHES["knn_topk"] += 1
    return out_d, out_i


def knn_operations(L: int, nq: int, n: int, d: int) -> float:
    """f32 operations the function needs: the distance product once for all
    lanes (a multiply and an add a feature) and one compare a (lane,
    query, row) to merge."""
    return 2.0 * nq * n * d + float(L) * nq * n


def knn_bytes(L: int, nq: int, n: int, d: int, k: int) -> int:
    """Bytes the function must move: queries, training rows and lane
    weights read once, the distances and indices written once."""
    return 4 * (nq * d + n * d + L * n + 2 * L * nq * k)
