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

Design (csrc/hist.cu). One C call first buckets each lane's live rows
(node id in range, a nonzero stat) by node: counts, their exclusive scan
``off [L, n_nodes + 1]`` and a node-sorted row list ``[L, n]``
(``bucket_rows_reference`` is its plain mirror). Each CTA then owns a
page, a run of at most ``Mb`` consecutive nodes by ``Fb`` features, and
reads only its nodes' contiguous segment of the list. Pages also start
where a lane's live rows cross a multiple of ``T`` (``hist_pages``), so
their rows, not their node counts, stay balanced on uneven levels; the
device cuts them (``page_starts_reference`` mirrors it), and the grid is
sized for the most pages that can come out. The scratch is one int32
tensor from ``torch.empty`` (``scratch_ints``).
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
#: shared-memory page a CTA aims at (two CTAs resident on each SM)
PAGE_BYTES = 96 * 1024
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


def hist_pages(n: int, n_nodes: int, Mb: int) -> Tuple[int, int]:
    """(T, max_pages) of a lane's page cut: a page starts at every Mb-th
    node and where the live rows cross a multiple of T, with T the rows of
    an average node block, so a page carries about T rows beside its
    largest node (with one node a page
    there is nothing to cut). max_pages bounds the pages that rule can give: one a
    node block plus one a crossing (``hist_level_histogram`` checks it)."""
    node_pages = -(-n_nodes // Mb)
    if Mb == 1:  # one node a page already: no row cut (T above any count)
        return n + 1, node_pages
    T = max(1, -(-n // node_pages))
    return T, node_pages + n // T


def scratch_ints(L: int, n: int, n_nodes: int, max_pages: int) -> int:
    """int32 scratch of one call (``hist_scratch_ints`` in csrc/hist.cu):
    cursors, offsets, the row list, page starts and page counts."""
    return L * (n_nodes + (n_nodes + 1) + n + (max_pages + 1) + 1)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def bucket_rows_reference(local, n_nodes: int, SC=None):
    """Plain mirror of the kernel's bucketing pass: ``(off [L, n_nodes + 1],
    rows [L, n])`` int32, where lane l's rows of node m are ``rows[l,
    off[l, m]:off[l, m + 1]]`` (ascending here; the kernel's atomics leave
    them in any order) and ``off[l, -1]`` is the lane's live row count;
    the rest of ``rows[l]`` is -1. Dead rows (node id < 0 or >= n_nodes)
    drop out, and with ``SC`` so do rows whose stats are all zero (they add
    nothing), as in the kernel."""
    L, n = local.shape
    local = local.long()
    live = (local >= 0) & (local < n_nodes)
    if SC is not None:
        live &= (SC != 0).any(dim=-1)
    key = torch.where(live, local, torch.full_like(local, n_nodes))
    counts = torch.zeros((L, n_nodes + 1), dtype=torch.long, device=local.device)
    counts.scatter_add_(1, key, torch.ones_like(key))
    off = torch.zeros((L, n_nodes + 1), dtype=torch.long, device=local.device)
    off[:, 1:] = torch.cumsum(counts[:, :n_nodes], dim=1)
    order = torch.sort(key, dim=1, stable=True).indices
    rows = torch.where(torch.arange(n, device=local.device)[None] < off[:, -1:],
                       order, torch.full_like(order, -1))
    return off.int(), rows.int()


def page_starts_reference(off, Mb: int, T: int):
    """Plain mirror of the kernel's page cut for one lane's offsets
    ``off [n_nodes + 1]``: the first node of every page, then n_nodes. A
    node m starts a page if m % Mb == 0 or the rows before it cross a
    multiple of T (``off[m] // T > off[m - 1] // T``)."""
    off = off.long()
    n_nodes = off.shape[0] - 1
    m = torch.arange(n_nodes, device=off.device)
    crossed = torch.zeros(n_nodes, dtype=torch.bool, device=off.device)
    crossed[1:] = off[1:n_nodes] // T > off[:n_nodes - 1] // T
    starts = m[(m % Mb == 0) | crossed]
    return torch.cat([starts, torch.tensor([n_nodes], device=off.device)]).int()


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
        lib.hist_level_histogram.argtypes = [P] * 5 + [I] * 11 + [P]
        lib.hist_level_histogram.restype = I
        lib.hist_page_bytes.argtypes = [I] * 4
        lib.hist_page_bytes.restype = ctypes.c_longlong
        lib.hist_scratch_ints.argtypes = [I] * 4
        lib.hist_scratch_ints.restype = ctypes.c_longlong
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
    T, max_pages = hist_pages(n, n_nodes, Mb)
    out = torch.empty((L, n_nodes, d, n_bins, kk), dtype=torch.float32, device=dev)
    scratch = torch.empty(scratch_ints(L, n, n_nodes, max_pages), dtype=torch.int32,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().hist_level_histogram(
            *(ctypes.c_void_p(t.data_ptr()) for t in (xb, local, SC, out, scratch)),
            n, d, kk, L, n_nodes, n_bins, Mb, Fb, T, max_pages, int(bool(integer_stats)),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"hist_level_histogram failed: CUDA error {err}")
    LAUNCHES["level_histogram"] += 1
    return out


def hist_bytes(L: int, n: int, d: int, kk: int, n_nodes: int, n_bins: int) -> int:
    """Bytes the function must move: codes, node ids and stats read once,
    the histogram written once."""
    return 4 * (n * d + L * n + L * n * kk + L * n_nodes * d * n_bins * kk)


def grid_ctas(n: int, n_nodes: int, d: int, n_bins: int, kk: int, L: int) -> int:
    """CTAs of the histogram launch: every page a lane could have, by
    feature block (those past a lane's page count return at once)."""
    Mb, Fb = hist_tile(n_nodes, d, n_bins, kk, L)
    return L * hist_pages(n, n_nodes, Mb)[1] * math.ceil(d / Fb)
