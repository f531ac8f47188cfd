"""Tree level histogram: a hand-written CUDA kernel for Hopper.

Counterpart of the JAX package's ``ops/pallas_hist.py``. One kernel, in
``csrc/hist.cu``, beside its plain PyTorch version:

- ``level_histogram`` (replaces ``pallas_hist.py:106``,
  ``level_histogram_pallas``)
      H[l, m, f, b, k] = sum_r [local[l, r] == m] * SC[l, r, k] * [xb[r, f] == b]

with an explicit lane axis l (one (trial, split) fit per lane; the JAX
package vmaps the single-lane function instead). The bin codes are shared
by every lane. Rows whose node id lies outside ``[0, n_nodes)`` are
dropped and rows with zero stats add nothing.

Dispatch. Given CPU tensors the wrapper computes the plain version; given
CUDA tensors it launches the kernel or raises. Nothing falls back from
the card to the plain version. ``LAUNCHES`` counts kernel launches.

Bounds (H100 SXM, 3.35 TB/s): the function reads the codes, node ids and
stats once and writes the histogram once; its adds are a few per (row,
feature). At the deep arena's widest covertype level (6 lanes, 116,202
rows, 1536 nodes, 54 features, 16 bins, 7 classes) that is ~0.27 GB,
~81 us: bytes bound it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

#: the kernel's limits (csrc/hist.cu): stat columns, bins, shared memory
MAX_STATS = 16
MAX_BINS = 256
SMEM_LIMIT = 232_448
#: shared-memory page a CTA aims at, beside its row list (two CTAs resident
#: on each SM); the list holds a 2,048-row tile's row (i32) and node (u16)
PAGE_BYTES = 96 * 1024
LIST_BYTES = 2048 * 6
#: CTAs that keep two resident on each of an H100's 132 SMs
_FILL_CTAS = 264

#: kernel launches, for showing that a run went through the kernel
LAUNCHES = {"level_histogram": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# geometry (pure shape arithmetic)
# ---------------------------------------------------------------------------


def hist_applicable(n_bins: int, kk: int) -> bool:
    """Shapes the kernel takes: up to 16 stat columns and 256 bins (the
    contract of the TPU kernel's gate, ``pallas_hist.py:154``; the page
    is blocked over nodes and features, so ``d * n_bins`` is free)."""
    return 1 <= kk <= MAX_STATS and 1 <= n_bins <= MAX_BINS


def page_bytes(Mb: int, Fb: int, n_bins: int, kk: int) -> int:
    """Shared memory of one CTA's page (``page_bytes`` in csrc/hist.cu)."""
    return Mb * Fb * n_bins * kk * 4


def hist_tile(n_nodes: int, d: int, n_bins: int, kk: int, L: int) -> Tuple[int, int]:
    """(nodes, features) per CTA page: as many (node, feature) cells as fit
    ``PAGE_BYTES``, but few enough that the grid fills the card. Whole
    feature rows first (a row's codes are read once per page), then
    feature blocks of one node."""
    cell = n_bins * kk * 4
    cap = max(1, PAGE_BYTES // cell)
    per_lane = -(-_FILL_CTAS // L)
    cells = max(1, min(cap, -(-(n_nodes * d) // per_lane)))
    if cells >= d:
        return min(n_nodes, cells // d), d
    fb = -(-d // -(-d // cells))  # even feature blocks of at most `cells`
    return 1, fb


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def level_histogram_reference(local, xb, SC, n_nodes: int, n_bins: int):
    """Plain version of ``level_histogram``: bin-and-scatter, one
    ``index_add_`` per feature (``pallas_hist.py:160``,
    ``level_histogram_scatter``). f32 accumulation, exact for integer
    stats below 2^24."""
    L, n = local.shape
    d = xb.shape[1]
    kk = SC.shape[-1]
    local = local.long()
    valid = (local >= 0) & (local < n_nodes)
    lanes, rows = valid.nonzero(as_tuple=True)
    src = SC[lanes, rows].float()  # [N, kk]
    base = (lanes * n_nodes + local[lanes, rows]) * d  # [N]
    codes = xb[rows].long()  # [N, d]
    H = torch.zeros((L * n_nodes * d * n_bins, kk), dtype=torch.float32, device=SC.device)
    for f in range(d):
        b = codes[:, f]
        ok = (b >= 0) & (b < n_bins)
        idx = (base + f) * n_bins + b
        H.index_add_(0, idx[ok], src[ok])
    return H.view(L, n_nodes, d, n_bins, kk)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """The built csrc/hist.cu with its C signatures declared."""
    global _lib_handle
    if _lib_handle is None:
        from .cuda_build import load

        lib = load("hist")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.hist_level_histogram.argtypes = [P] * 4 + [I] * 9 + [P]
        lib.hist_level_histogram.restype = I
        lib.hist_page_bytes.argtypes = [I] * 4
        lib.hist_page_bytes.restype = ctypes.c_longlong
        _lib_handle = lib
    return _lib_handle


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def level_histogram(local, xb, SC, n_nodes: int, n_bins: int, *,
                    integer_stats: bool = False):
    """[L, n_nodes, d, n_bins, kk] level histograms of L lanes.

    local [L, n] i32 node id per row and lane (others dropped)
    xb    [n, d] i32 bin codes, shared by the lanes
    SC    [L, n, kk] f32 stats (integer-valued when ``integer_stats``)

    ``integer_stats`` accumulates in int32 (bit-exact, order-free); float
    stats accumulate in f32 atomics (summation-order tolerance).
    """
    devs = {t.device for t in (local, xb, SC)}
    if len(devs) != 1:
        raise ValueError(f"tensors span several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return level_histogram_reference(local, xb, SC, n_nodes, n_bins)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    L, n = local.shape
    d, kk = xb.shape[1], SC.shape[-1]
    _check("local", local, torch.int32, (L, n))
    _check("xb", xb, torch.int32, (n, d))
    _check("SC", SC, torch.float32, (L, n, kk))
    if not hist_applicable(n_bins, kk) or n == 0:
        raise ValueError(
            f"level_histogram: no kernel geometry for n_bins={n_bins}, kk={kk}, n={n}")
    Mb, Fb = hist_tile(n_nodes, d, n_bins, kk, L)
    out = torch.empty((L, n_nodes, d, n_bins, kk), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().hist_level_histogram(
            ctypes.c_void_p(xb.data_ptr()), ctypes.c_void_p(local.data_ptr()),
            ctypes.c_void_p(SC.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            n, d, kk, L, n_nodes, n_bins, Mb, Fb, int(bool(integer_stats)),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"hist_level_histogram failed: CUDA error {err}")
    LAUNCHES["level_histogram"] += 1
    return out


def hist_bytes(L: int, n: int, d: int, kk: int, n_nodes: int, n_bins: int) -> int:
    """Bytes the function must move: codes, node ids and stats read once,
    the histogram written once."""
    return 4 * (n * d + L * n + L * n * kk + L * n_nodes * d * n_bins * kk)


def grid_ctas(n_nodes: int, d: int, n_bins: int, kk: int, L: int) -> int:
    Mb, Fb = hist_tile(n_nodes, d, n_bins, kk, L)
    return L * math.ceil(n_nodes / Mb) * math.ceil(d / Fb)
