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
the card to the plain version. ``LAUNCHES`` counts calls that launched.

Integer stats (``integer_stats=True``, RF classification). Bounds (H100
SXM, 3.35 TB/s): the function reads the codes, node ids and stats once and
writes the histogram once; its adds are a few per (row, feature). At the
deep arena's widest covertype level (6 lanes, 116,202 rows, 1536 nodes, 54
features, 16 bins, 7 classes) that is ~0.27 GB, ~81 us: bytes bound it.
One C call first buckets each lane's live rows (node id in range, a
nonzero stat) by node: counts, their exclusive scan ``off [L, n_nodes +
1]`` and a node-sorted row list ``[L, n]`` (``bucket_rows_reference`` is
its plain mirror). Each CTA then owns a page, a run of at most ``Mb``
consecutive nodes by ``Fb`` features, accumulates in int32 shared atomics
(bit-exact) and reads only its nodes' contiguous segment of the list.
Pages also start where a lane's live rows cross a multiple of ``T``
(``hist_pages``), so their rows, not their node counts, stay balanced on
uneven levels; the device cuts them (``page_starts_reference`` mirrors
it), and the grid is sized for the most pages that can come out.

Float stats (boosting and the regression trees). The TPU kernel's one-hot
contraction on the tensor cores: every f32 stat splits exactly into three
bf16 terms (``split_stats_reference``), each term's rows (lane, node, stat)
are multiplied by the bins' one-hot in ``wgmma`` into f32 accumulators in
a fixed order, so every launch gives the same bits. ``f32_plan`` picks,
by the cost of the whole launch (products and grid fill), the dense route
(every row in order, lanes and nodes batched into M, K split over the card
with the partials summed in split order) at shallow levels and the page
route (each lane's rows bucketed by node into a stable row list,
``bucket_rows_stable``) where a lane's (node, stat) rows pass a tile and
the pages fill the card; a call whose scratch would pass
``F32_SCRATCH_BYTES`` runs its lanes in several launches.
``split_contraction_reference`` is the plain mirror of both routes. At
boosting's root (168 lanes, 116,202 rows, 54 features, 128 bins) the three
products are 1.62e12 bf16 operations, 1.64 ms at 989 TFLOP/s.

The scratch is one int32 tensor from ``torch.empty`` (``scratch_ints``,
``f32_scratch_ints``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

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


#: the f32 contraction's tile: (lane, node, stat) rows, (feature, bin)
#: columns (256 a warpgroup) and rows a K step (csrc/hist.cu kF32M, kF32N,
#: kF32K), and the whole features a tile holds at most
F32_M, F32_N, F32_K = 64, 512, 64
F32_MAX_FEATURES = 32
#: rows a warp places in order in the page route's stable bucketing
F32_ROW_BLOCK = 1024
#: an H100's SMs; the f32 kernel keeps one CTA on each
SMS = 132
#: most K splits of the dense route
F32_MAX_SPLITS = 32
#: a CTA's cost beside its K steps (its first one-hot build, which no
#: product overlaps, and its epilogue), in K steps
F32_CTA_STEPS = 2
#: most scratch one f32 launch takes (A images, codes, partial pages, row
#: lists); a call that needs more runs its lanes in several launches
F32_SCRATCH_BYTES = 2 << 30
#: rows a level past the root gives the page route, as a share of n: the
#: builders histogram a level's left children only (``build_tree``,
#: ``build_tree_deep`` derive the right ones by subtraction), so about half
#: the rows carry stats, and the page route reads only those
F32_LIVE_SHARE = 0.5


class F32Plan(NamedTuple):
    """The f32 launches of one call: ``route``, ``lanes`` a launch (the
    last takes the rest), ``launches``, the dense route's K ``splits`` and
    the ``ctas`` of a full launch, and ``cost``, the K steps of the busiest
    SM summed over the launches."""

    route: str
    lanes: int
    launches: int
    splits: int
    ctas: int
    cost: int


def f32_features(d: int, n_bins: int) -> int:
    """Whole features a tile's 512 columns hold (``f32_features``)."""
    return max(1, min(d, F32_N // n_bins, F32_MAX_FEATURES))


def f32_page_nodes(kk: int) -> int:
    """Nodes a page of the page route: its (node, stat) rows fill a tile."""
    return F32_M // kk


@functools.lru_cache(maxsize=1024)
def f32_launch(route: str, lanes: int, n: int, d: int, n_bins: int, n_nodes: int,
               kk: int) -> Tuple[int, int, int]:
    """(cost, splits, CTAs) of one launch of ``lanes`` lanes, its cost in K
    steps of the busiest SM: waves of one CTA an SM times a CTA's K steps
    (plus F32_CTA_STEPS). Dense: N tiles x M tiles x K splits, every CTA a
    split's share of all n rows, with the splits (at most F32_MAX_SPLITS
    and the K steps) whose cost is least, among equals the most. Page: N
    tiles x pages x lanes, one CTA a page, taken to hold an even share of
    the live rows, all n at the root and F32_LIVE_SHARE of them past it
    (shape arithmetic cannot see how the data spreads them)."""
    n_tiles = -(-d // f32_features(d, n_bins))
    ksteps = -(-n // F32_K)
    if route == "page":
        pages = -(-n_nodes // f32_page_nodes(kk))
        ctas = n_tiles * pages * lanes
        live = n if n_nodes == 1 else math.ceil(n * F32_LIVE_SHARE)
        per = -(-(-(-live // pages)) // F32_K)
        return -(-ctas // SMS) * (per + F32_CTA_STEPS), 1, ctas
    tiles = -(-(lanes * n_nodes * kk) // F32_M) * n_tiles
    best = None
    for s in range(1, min(F32_MAX_SPLITS, ksteps) + 1):
        cost = -(-(tiles * s) // SMS) * (-(-ksteps // s) + F32_CTA_STEPS)
        if best is None or cost <= best[0]:
            best = (cost, s, tiles * s)
    return best


def _route_plan(route: str, L: int, n: int, d: int, n_bins: int, n_nodes: int,
                kk: int) -> F32Plan:
    """One route's launches: lanes a launch at most as many as keep its
    scratch within F32_SCRATCH_BYTES (one at least), and of the few lane
    counts at that bound the one of least cost (a last launch of a few
    lanes leaves the card idle)."""
    def scratch(lanes):
        splits = f32_launch(route, lanes, n, d, n_bins, n_nodes, kk)[1]
        return 4 * f32_scratch_ints(lanes, n, d, n_bins, kk, n_nodes, route, splits)

    top = max(1, min(L, L * F32_SCRATCH_BYTES // max(1, scratch(L))))
    while top > 1 and scratch(top) > F32_SCRATCH_BYTES:
        top -= 1
    best = None
    for launches in range(-(-L // top), -(-L // top) + 3):
        lanes = -(-L // launches)
        launches = -(-L // lanes)
        full = f32_launch(route, lanes, n, d, n_bins, n_nodes, kk)
        rest = L - (launches - 1) * lanes
        cost = (launches - 1) * full[0] + f32_launch(route, rest, n, d, n_bins, n_nodes,
                                                     kk)[0]
        if best is None or cost < best.cost:
            best = F32Plan(route, lanes, launches, full[1], full[2], cost)
    return best


@functools.lru_cache(maxsize=1024)
def f32_plan(L: int, n: int, d: int, n_bins: int, n_nodes: int, kk: int,
             route: Optional[str] = None) -> F32Plan:
    """The f32 launches of one call by ``route``, or (None) by the route
    whose launches cost least, dense among equals (no bucketing, nothing
    that depends on the data). The cost weighs the whole launch: dense
    multiplies every lane's (node, stat) rows, batched into M, by every
    row, so its products grow with n_nodes * kk, but its K splits spread
    any level over the card; a page multiplies its own 64 (node, stat)
    rows by its own rows only, one CTA a page. So boosting's shallow
    levels go dense, and a level of a tile of (node, stat) rows a lane or
    more goes to the page route once its CTAs fill the card (PERF.md, B4's f32
    rows: the card's times on both sides of the crossover, 168 lanes at
    16, 32 and 64 nodes)."""
    routes = ("dense", "page") if route is None else (route,)
    plans = [_route_plan(r, L, n, d, n_bins, n_nodes, kk) for r in routes]
    return min(plans, key=lambda p: (p.cost, p.route != "dense"))


def f32_route(L: int, n: int, d: int, n_bins: int, n_nodes: int, kk: int) -> str:
    """``"dense"`` or ``"page"``: ``f32_plan``'s route."""
    return f32_plan(L, n, d, n_bins, n_nodes, kk).route


def f32_split_rows(n: int, splits: int) -> list:
    """The dense route's K splits as row ranges ``[(r0, r1), ...]``: whole
    K steps, in order (the kernel's ``split_steps``)."""
    ksteps = -(-n // F32_K)
    per = -(-ksteps // splits) * F32_K
    return [(min(n, s * per), min(n, (s + 1) * per)) for s in range(splits)]


def f32_smem_bytes(Fn: int) -> int:
    """Shared memory of one f32 CTA (``hist_f32_smem_bytes``): alignment
    slack, three A image slots (three bf16 terms each), two one-hot slots,
    three codes slots, each one-hot slot's last codes and three
    mbarriers."""
    image = 3 * F32_M * F32_K * 2
    return 1024 + 3 * image + 2 * F32_N * F32_K * 2 + 5 * Fn * F32_K * 2 + 24


def f32_scratch_ints(L: int, n: int, d: int, n_bins: int, kk: int, n_nodes: int,
                     route: str, splits: int) -> int:
    """int32 scratch of one f32 call (``hist_f32_scratch_ints``). Dense:
    the split A images (24 KB a (M tile, K step)), the codes [N tiles, K
    steps, Fn, 64] u16, and the partial pages when splits > 1. Page: the
    stable bucketing (counts [L, n_nodes, row blocks], offsets [L, n_nodes
    + 1], rows [L, n]), each page's first step [L, pages + 1], then the A
    images and codes of a lane's steps, at most ceil(n / 64) + pages."""
    Fn = f32_features(d, n_bins)
    n_tiles = -(-d // Fn)
    image = 3 * F32_M * F32_K // 2
    steps = -(-n // F32_K)
    if route == "page":
        pages = -(-n_nodes // f32_page_nodes(kk))
        nblk = -(-n // F32_ROW_BLOCK)
        head = -(-L * (n_nodes * nblk + n_nodes + 1 + n + pages + 1) // 4) * 4
        ksteps = steps + pages
        return head + L * ksteps * image + L * ksteps * n_tiles * Fn * F32_K // 2
    m_tiles = -(-(L * n_nodes * kk) // F32_M)
    part = splits * L * n_nodes * d * n_bins * kk if splits > 1 else 0
    return m_tiles * steps * image + n_tiles * steps * Fn * F32_K // 2 + part


def f32_lane_bytes(n: int, d: int, n_bins: int, kk: int = 2) -> int:
    """Scratch one lane of an f32 call may take: its A images and codes on
    the page route (a page's K steps over every row), which the dense
    route's share does not pass where ``f32_plan`` picks it; no launch
    takes more than F32_SCRATCH_BYTES in all. What a model's memory
    estimate prices a lane."""
    return min(F32_SCRATCH_BYTES,
               4 * f32_scratch_ints(1, n, d, n_bins, kk, f32_page_nodes(kk), "page", 1))


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def bucket_rows_reference(local, n_nodes: int, SC=None):
    """Plain mirror of the kernel's bucketing pass: ``(off [L, n_nodes + 1],
    rows [L, n])`` int32, where lane l's rows of node m are ``rows[l,
    off[l, m]:off[l, m + 1]]`` (ascending, as the f32 mode's stable
    bucketing places them; the int32 mode's atomics leave them in any
    order) and ``off[l, -1]`` is the lane's live row count;
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


def split_stats_reference(SC):
    """The f32 mode's exact split of the stats into three bf16 terms
    ``(hi, mid, lo)``: hi = bf16(s), mid = bf16(s - hi), lo = bf16(s - hi -
    mid), each difference exact in f32, so hi + mid + lo == s to the bit
    for finite stats (two terms alone miss by up to ~8e-6 relative). A
    test aid: the kernel splits in registers."""
    s = SC.float()
    hi = s.to(torch.bfloat16)
    r1 = s - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def split_contraction_reference(local, xb, SC, n_nodes: int, n_bins: int,
                                route: Optional[str] = None):
    """Plain mirror of the f32 kernel's arithmetic: the (lane, node, stat)
    rows of the three bf16 terms contracted with the bins' one-hot over K
    rows in f32. ``route`` (default ``f32_route``): ``"dense"`` takes K over
    every row in order, lanes and nodes batched into M; ``"page"`` takes,
    for each lane and page of ``f32_page_nodes`` nodes, K over the page's
    segment of the stable row list (``bucket_rows_reference``). The sum
    order is matmul's, not the tensor cores', so this holds the design
    within f32 tolerance, not to the bit. A test aid, off the card's
    path."""
    L, n = local.shape
    d, kk = xb.shape[1], SC.shape[-1]
    if route is None:
        route = f32_route(L, n, d, n_bins, n_nodes, kk)
    codes = xb.long()
    onehot = torch.zeros((n, d, n_bins), dtype=torch.float32, device=xb.device)
    ok = (codes >= 0) & (codes < n_bins)
    onehot.scatter_(2, codes.clamp(0, n_bins - 1)[..., None], ok[..., None].float())
    onehot = onehot.reshape(n, d * n_bins)
    node1h = torch.nn.functional.one_hot(
        torch.where((local >= 0) & (local < n_nodes), local.long(), n_nodes),
        n_nodes + 1)[..., :n_nodes].float()  # [L, n, n_nodes]
    H = torch.zeros((L, n_nodes, kk, d * n_bins), dtype=torch.float32, device=SC.device)
    off, rows = bucket_rows_reference(local, n_nodes, SC)
    Mb = f32_page_nodes(kk)
    for term in split_stats_reference(SC):
        A = node1h[..., :, None] * term.float()[..., None, :]  # [L, n, n_nodes, kk]
        if route == "dense":
            H += torch.einsum("lrmk,rc->lmkc", A, onehot)
            continue
        for lane in range(L):
            for m0 in range(0, n_nodes, Mb):
                m1 = min(n_nodes, m0 + Mb)
                seg = rows[lane, int(off[lane, m0]):int(off[lane, m1])].long()
                H[lane, m0:m1] += torch.einsum("rmk,rc->mkc", A[lane, seg, m0:m1],
                                               onehot[seg])
    return H.view(L, n_nodes, kk, d, n_bins).permute(0, 1, 3, 4, 2).contiguous()


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
        lib.hist_level_histogram.argtypes = [P] * 5 + [I] * 10 + [P]
        lib.hist_level_histogram.restype = I
        lib.hist_level_histogram_f32.argtypes = [P] * 5 + [I] * 8 + [P]
        lib.hist_level_histogram_f32.restype = I
        lib.hist_stable_rows.argtypes = [P] * 3 + [I] * 4 + [P]
        lib.hist_stable_rows.restype = I
        lib.hist_page_bytes.argtypes = [I] * 4
        lib.hist_page_bytes.restype = ctypes.c_longlong
        lib.hist_scratch_ints.argtypes = [I] * 4
        lib.hist_scratch_ints.restype = ctypes.c_longlong
        lib.hist_f32_smem_bytes.argtypes = [I]
        lib.hist_f32_smem_bytes.restype = ctypes.c_longlong
        lib.hist_f32_scratch_ints.argtypes = [I] * 8
        lib.hist_f32_scratch_ints.restype = ctypes.c_longlong
        _lib_handle = lib
    return _lib_handle


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _device(*tensors) -> torch.device:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors span several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _ptrs(*tensors):
    return tuple(ctypes.c_void_p(t.data_ptr()) for t in tensors)


def level_histogram(local, xb, SC, n_nodes: int, n_bins: int, *,
                    integer_stats: bool = False):
    """[L, n_nodes, d, n_bins, kk] level histograms of L lanes.

    local [L, n] i32 node id per row and lane (others dropped)
    xb    [n, d] i32 bin codes, shared by the lanes
    SC    [L, n, kk] f32 stats (integer-valued when ``integer_stats``)

    ``integer_stats`` accumulates in int32 (bit-exact, order-free); float
    stats go through the split one-hot contraction (f32 tolerance, the
    same bits on every launch).
    """
    dev = _device(local, xb, SC)
    if dev.type == "cpu":
        return level_histogram_reference(local, xb, SC, n_nodes, n_bins)
    out = _launch(local, xb, SC, n_nodes, n_bins, "int32" if integer_stats else None)
    LAUNCHES["level_histogram"] += 1
    return out


def level_histogram_f32_route(local, xb, SC, n_nodes: int, n_bins: int, route: str):
    """The f32 kernel by the route given (``"dense"`` or ``"page"``) on CUDA
    tensors: a measurement aid (``chip_smoke.py`` and ``kernel_ab.py`` time
    the route ``f32_plan`` did not pick), not counted in ``LAUNCHES``."""
    if _device(local, xb, SC).type != "cuda" or route not in ("dense", "page"):
        raise ValueError(f"level_histogram_f32_route: CUDA tensors and a route, got "
                         f"{local.device}, {route!r}")
    return _launch(local, xb, SC, n_nodes, n_bins, route)


def _launch(local, xb, SC, n_nodes: int, n_bins: int, mode: Optional[str]):
    """One call on CUDA tensors: ``mode`` ``"int32"`` (the integer-stat
    pages), ``"dense"`` or ``"page"`` (the f32 routes), or None (the f32
    route ``f32_plan`` picks; its launches take the lanes in order)."""
    dev = local.device
    L, n = local.shape
    d, kk = xb.shape[1], SC.shape[-1]
    _check("local", local, torch.int32, (L, n))
    _check("xb", xb, torch.int32, (n, d))
    _check("SC", SC, torch.float32, (L, n, kk))
    if not hist_applicable(n_bins, kk) or n == 0:
        raise ValueError(
            f"level_histogram: no kernel geometry for n_bins={n_bins}, kk={kk}, n={n}")
    out = torch.empty((L, n_nodes, d, n_bins, kk), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        if mode == "int32":
            Mb, Fb = hist_tile(n_nodes, d, n_bins, kk, L)
            T, max_pages = hist_pages(n, n_nodes, Mb)
            scratch = torch.empty(scratch_ints(L, n, n_nodes, max_pages), dtype=torch.int32,
                                  device=dev)
            err = _lib().hist_level_histogram(
                *_ptrs(xb, local, SC, out, scratch), n, d, kk, L, n_nodes, n_bins, Mb, Fb,
                T, max_pages, stream)
        else:
            plan = f32_plan(L, n, d, n_bins, n_nodes, kk, mode)
            launches = [(l0, min(L, l0 + plan.lanes)) for l0 in range(0, L, plan.lanes)]
            splits = [f32_launch(plan.route, l1 - l0, n, d, n_bins, n_nodes, kk)[1]
                      for l0, l1 in launches]
            scratch = torch.empty(
                max(f32_scratch_ints(l1 - l0, n, d, n_bins, kk, n_nodes, plan.route, sp)
                    for (l0, l1), sp in zip(launches, splits)),
                dtype=torch.int32, device=dev)
            for (l0, l1), sp in zip(launches, splits):  # lanes in order: same bits every call
                err = _lib().hist_level_histogram_f32(
                    *_ptrs(xb, local[l0:l1], SC[l0:l1], out[l0:l1], scratch), n, d, kk,
                    l1 - l0, n_nodes, n_bins, int(plan.route == "page"), sp, stream)
                if err != 0:
                    break
    if err != 0:
        raise RuntimeError(f"hist_level_histogram failed: CUDA error {err}")
    return out


def bucket_rows_stable(local, n_nodes: int, SC):
    """``(off, rows)`` of the page route's stable bucketing, as
    ``bucket_rows_reference(local, n_nodes, SC)`` gives them: on the card
    the f32 mode's three bucketing kernels alone (a test aid; not counted
    in ``LAUNCHES``), on the CPU the plain version."""
    dev = _device(local, SC)
    if dev.type == "cpu":
        return bucket_rows_reference(local, n_nodes, SC)
    L, n = local.shape
    kk = SC.shape[-1]
    _check("local", local, torch.int32, (L, n))
    _check("SC", SC, torch.float32, (L, n, kk))
    nblk = -(-n // F32_ROW_BLOCK)  # counts [L, n_nodes, nblk], then off and rows
    scratch = torch.empty(L * (n_nodes * nblk + n_nodes + 1 + n), dtype=torch.int32,
                          device=dev)
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        err = _lib().hist_stable_rows(*_ptrs(local, SC, scratch), n, kk, L, n_nodes, stream)
    if err != 0:
        raise RuntimeError(f"hist_stable_rows failed: CUDA error {err}")
    at = L * n_nodes * nblk
    off = scratch[at:at + L * (n_nodes + 1)].view(L, n_nodes + 1)
    at += L * (n_nodes + 1)
    rows = scratch[at:at + L * n].view(L, n)
    return off, rows


def hist_bytes(L: int, n: int, d: int, kk: int, n_nodes: int, n_bins: int) -> int:
    """Bytes the function must move: codes, node ids and stats read once,
    the histogram written once."""
    return 4 * (n * d + L * n + L * n * kk + L * n_nodes * d * n_bins * kk)


def grid_ctas(n: int, n_nodes: int, d: int, n_bins: int, kk: int, L: int) -> int:
    """CTAs of the integer-stat launch: every page a lane could have, by
    feature block (those past a lane's page count return at once); the
    f32 mode's are ``f32_plan``'s."""
    Mb, Fb = hist_tile(n_nodes, d, n_bins, kk, L)
    return L * hist_pages(n, n_nodes, Mb)[1] * math.ceil(d / Fb)
