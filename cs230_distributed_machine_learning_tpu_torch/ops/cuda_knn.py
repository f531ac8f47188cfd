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
card to the plain version. ``LAUNCHES`` counts wrapper calls that launched
the kernel (one a call, whether or not the call also ran the merge). The
kernel takes any k: up to ``SHARED_LISTS_MAX_K`` its per-query lists live
in shared memory, above it in device memory (kept as max-heaps and sorted
at the end), by the same insertion rule and with the same result;
``knn_list_mode`` says which.

Launch plan (``knn_plan``, pure shape arithmetic that the C entry checks):
a CTA serves a block of 64 or 32 queries and a group of lanes that share
each distance tile, the largest group (at most ``MAX_GROUP``) whose lists
fit in shared memory, and the training rows are cut into P contiguous
ranges of whole tiles so that the grid fills the card; the P partial lists of each (lane, query) are merged
by (d2, j) in a second kernel of the same call. Since a range's list is the
k smallest of its rows by (d2, j), the merged lists equal the unsplit ones
to the bit; ``knn_topk_ranges_reference`` is the plain counterpart.

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
#: the most lanes one CTA serves, and the most row ranges of a launch
MAX_GROUP = 16
MAX_RANGES = 32
#: dynamic shared memory a CTA may use, and an SM's shared memory (H100);
#: the system reserves 1 KB of the SM's a resident CTA
SMEM_LIMIT = 232_448
SM_SMEM = 233_472
_CTA_RESERVED = 1024
#: an H100's SMs; a range keeps at least this many 128-row tiles
SMS = 132
MIN_RANGE_TILES = 4
#: the kernel's tile sizes (csrc/knn.cu): queries a CTA owns (64, or 32
#: where that lets more CTAs share an SM), rows a tile
QUERY_BLOCKS = (64, 32)
BT = 128
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


def smem_bytes(k: int, lanes: int = 1, bq: int = 64) -> int:
    """Shared memory of one CTA serving ``lanes`` lanes and ``bq`` queries
    at ``k`` (``smem_bytes`` in csrc/knn.cu): the transposed query and tile
    chunks, the distance tile, the norms, two tiles' row masks a lane, and
    the lanes' lists when they live in shared memory."""
    lists = lanes * bq * k * 8 if knn_list_mode(k) == "shared" else 0
    return (4 * (64 * (bq + 4) + 64 * (BT + 4) + bq * (BT + 4) + bq + BT)
            + 2 * 4 * lanes * BT + lists)


def lane_group(L: int, k: int, bq: int = 64) -> int:
    """Lanes a CTA of ``bq`` queries serves: the most, up to
    ``MAX_GROUP`` and L, whose lists fit in a CTA's shared memory (one
    lane at k = 256), spread evenly over the fewest groups that cover L.
    With the lists in device memory (k above 256) one lane: there the
    heaps' insertions, not the distance product, set the time, and sharing
    a tile saves only the product."""
    if L < 1:
        raise ValueError(f"lane_group: L={L} must be at least 1")
    if knn_list_mode(k) == "device":
        return 1
    G = min(L, MAX_GROUP)
    while G > 1 and smem_bytes(k, G, bq) > SMEM_LIMIT:
        G -= 1
    n_groups = -(-L // G)
    return -(-L // n_groups)


def _resident(smem: int) -> int:
    """CTAs an SM holds at this shared memory (at most two: the kernel's
    launch bounds)."""
    return max(1, min(2, SM_SMEM // (smem + _CTA_RESERVED)))


def knn_plan(nq: int, n: int, L: int, k: int) -> dict:
    """The kernel's launch plan: the query block (64, or 32 where that
    takes fewer lane groups or lets more CTAs share an SM; 64 with the
    lists in device memory), lane group G and its count, and P row ranges
    of ``tiles_per_range`` 128-row tiles (every range non-empty). P is the
    CTAs the SMs hold at this shared memory over the CTAs the queries and
    lane groups give, at most ``MAX_RANGES``, each range
    ``MIN_RANGE_TILES`` tiles or more; so a grid that fills the card
    already is not split (each range's lists fill anew, which above k 256
    costs more insertions than it saves)."""
    def cost(bq):  # fewer lane groups first (each redoes the product), then occupancy
        G = lane_group(L, k, bq)
        return -(-L // G), -_resident(smem_bytes(k, G, bq))

    bq = 64 if knn_list_mode(k) == "device" else min(QUERY_BLOCKS, key=cost)
    G = lane_group(L, k, bq)
    n_groups = -(-L // G)
    blocks = -(-nq // bq) * n_groups
    smem = smem_bytes(k, G, bq)
    resident = _resident(smem)
    n_tiles = -(-n // BT)
    P = max(1, min(MAX_RANGES, resident * SMS // blocks, n_tiles // MIN_RANGE_TILES))
    tiles_per_range = -(-n_tiles // P)
    P = -(-n_tiles // tiles_per_range)
    return {"query_block": bq, "lane_group": G, "lane_groups": n_groups, "ranges": P,
            "tiles_per_range": tiles_per_range, "smem_bytes": smem,
            "ctas": blocks * P}


def row_ranges(n: int, ranges: int):
    """The P contiguous row ranges [j0, j1) of whole 128-row tiles that
    the kernel splits n training rows into (as ``knn_plan`` sizes them)."""
    n_tiles = -(-n // BT)
    tpr = -(-n_tiles // ranges)
    return [(t * BT, min(n, (t + tpr) * BT)) for t in range(0, n_tiles, tpr)]


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


def knn_topk_ranges_reference(Q, Xt, W, k: int, ranges):
    """Plain counterpart of the kernel's row split: the plain version's
    lists over each row range [j0, j1) (indices shifted to the table's),
    merged by (d2, j) with a stable sort of the ranges' lists in range
    order (a tie keeps the earlier range, whose rows come first; empty
    slots sort last). Equal to ``knn_topk_reference`` over the whole table,
    bit for bit."""
    parts_d, parts_i = [], []
    for j0, j1 in ranges:
        d2, idx = knn_topk_reference(Q, Xt[j0:j1], W[:, j0:j1].contiguous(), k)
        parts_d.append(d2)
        parts_i.append(torch.where(idx >= 0, idx + j0, idx))
    cat_d = torch.cat(parts_d, dim=2)
    cat_i = torch.cat(parts_i, dim=2)
    sd, order = torch.sort(cat_d, dim=2, stable=True)
    return sd[..., :k].contiguous(), torch.gather(cat_i, 2, order[..., :k])


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
        lib.knn_topk.argtypes = [P] * 9 + [I] * 8 + [P]
        lib.knn_topk.restype = I
        for name in ("knn_max_shared_k", "knn_max_group", "knn_max_ranges"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = I
        lib.knn_smem_bytes.argtypes = [I, I, I]
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
    plan = knn_plan(nq, n, L, k)
    P = plan["ranges"]
    qsq, tsq = _sq_norms(Q, Xt)
    out_d = torch.empty((L, nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((L, nq, k), dtype=torch.int32, device=dev)
    # the ranges' partial lists, merged into out_d / out_i in the same call
    scratch = (torch.empty(P * L * nq * k, dtype=torch.float32, device=dev),
               torch.empty(P * L * nq * k, dtype=torch.int32, device=dev)) if P > 1 else ()
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (Q, Xt, qsq, tsq, W, out_d, out_i)]
    ptrs += [ctypes.c_void_p(t.data_ptr()) for t in scratch] or [None, None]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().knn_topk(*ptrs, nq, n, d, L, k, plan["lane_group"], P,
                              plan["query_block"], ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"knn_topk failed: CUDA error {err}")
    LAUNCHES["knn_topk"] += 1
    return out_d, out_i


def knn_operations(L: int, nq: int, n: int, d: int) -> float:
    """f32 operations the function needs: the distance product once for all
    lanes (a multiply and an add a feature) and one compare a (lane,
    query, row) to merge."""
    return 2.0 * nq * n * d + float(L) * nq * n


def knn_design_operations(L: int, nq: int, n: int, d: int, k: int) -> float:
    """f32 operations the kernel's plan does: the distance product once a
    lane group, and one compare a (lane, query, row). With one lane group
    (all lanes share each tile) it equals ``knn_operations``."""
    groups = knn_plan(nq, n, L, k)["lane_groups"]  # each group redoes the product
    return 2.0 * nq * n * d * groups + float(L) * nq * n


def knn_bytes(L: int, nq: int, n: int, d: int, k: int) -> int:
    """Bytes the function must move: queries, training rows and lane
    weights read once, the distances and indices written once."""
    return 4 * (nq * d + n * d + L * n + 2 * L * nq * k)
