"""Fused softmax-regression gradients: hand-written CUDA kernels for Hopper.

Counterpart of the JAX package's ``ops/pallas_logreg.py``. Three kernels,
in ``csrc/logreg.cu`` (B1's fused wide form in ``csrc/logreg_fused.cu``),
each beside its plain PyTorch version:

- ``packed_softmax_grad`` (replaces ``pallas_logreg.py:109``)
      G3[wb] = A^T (w * (softmax_c(A W3[wb]) - Y)) for every packed column;
- ``packed_nesterov_step`` (replaces ``pallas_logreg.py:228``)
      one whole Nesterov iteration of the packed fit, W / Wp updated in place;
- ``masked_softmax_grad`` (replaces ``pallas_logreg.py:372``)
      G[l] = A^T (wm[:, l] * (softmax(A W[l]) - Y)) for a batch of lanes.

The first two are one register-resident kernel body with two epilogues
(``step_geometry`` picks its tile) and compute the same gradient to the
bit. The masked kernel runs in two passes, logits and bf16 residual, then
the Gram product over P row ranges (``masked_plan``), with no cap on the
features or the classes: past ``CLASS_TILE`` classes a cluster of up to
eight CTAs holds a lane's class row, each a slice of it (the pitch k x N,
320 at 300 classes), and computes its logits once, each CTA's slice of the
weights resident in shared memory or, where it does not fit (many
features), streamed with the rows; past 2,048 classes a lane's classes are
tiled in two sweeps (the max and the denominator, then the residuals). Where no
register-resident geometry exists (dpp past it or more than 16 classes),
``packed_softmax_grad`` runs its wide form, by shape alone
(``route_plan``): to 256 classes the fused kernel (``fused_plan``): one
pass over 64-row tiles that keeps the bf16 residual in shared memory and
the gradient in registers, as the TPU kernel keeps them in VMEM, each A
tile read once for all of a CTA's lanes and classes; one CTA holds a
lane's classes to 64 at dpp 512, 80 at 448, 112 at 320 and 128 at 256,
and past that a cluster of 2 or 4 CTAs shares them, the softmax's max and
sum read across the cluster. Past 256 classes the masked kernel's two
passes on the packed layout (``wide_plan``), their lanes and rows split
into launches of at most ``WIDE_SCRATCH_BYTES`` of scratch.

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
real classes, 0.42 ms. B1's wide form at 256 trials of a 384-feature,
10-class table (n_pad 20,480, dpp 448, S 6) does 0.56 TFLOP of products
over the real classes, 0.57 ms; at 100 classes on 256 features (dpp 320,
one block) 2.0 TFLOP, 2.0 ms. Its fused kernel takes each at one call
with no residual in device memory (the first in two row ranges, whose
55 MB of partials are summed in order); the two passes wrote 1.0 and
4.0 GB of bf16 residual there.
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

#: pass (a)'s routes in B3 and in B1's wide form (``_pass_a_plan``)
PASS_A_ROUTES = ("lanes", "cluster", "cluster_ring", "sweeps")

#: kernel launches per wrapper, for showing which kernels a run used
LAUNCHES = {
    "packed_softmax_grad": 0,
    "packed_softmax_grad_fused": 0,
    "packed_softmax_grad_wide": 0,
    "packed_nesterov_step": 0,
    "masked_softmax_grad": 0,
}
#: the two-pass wrappers' launches (``LAUNCHES``'s) again, by pass (a)'s
#: route: ``<wrapper>_<route>``
PASS_A_LAUNCHES = {f"{k}_{r}": 0 for k in ("packed_softmax_grad_wide", "masked_softmax_grad")
                   for r in PASS_A_ROUTES}


def reset_launches() -> None:
    for counts in (LAUNCHES, PASS_A_LAUNCHES):
        for k in counts:
            counts[k] = 0


# ---------------------------------------------------------------------------
# geometry gates (pure shape arithmetic: CPU and card route identically)
# ---------------------------------------------------------------------------


def _align(x: int, a: int = 128) -> int:
    return (x + a - 1) // a * a


def _ld_f32(cols: int) -> int:
    return cols + (40 - cols % 32) % 32


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
    """B1's and B2's register-resident geometry at (dpp, c), or None: the
    lane tile L (16, else 8), N1 = L * (c rounded up to a power of two)
    columns (at most 128: one wgmma N, so at most 16 classes), MT feature
    atoms, so that the logits and a whole gradient (N1 / 2 * (MT + 1)
    floats a thread) would fit the registers and a ring stage fits shared
    memory."""
    if dpp <= 0 or dpp % 16 or c < 2:
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
    """Gate of the fused step B2 (the TPU's VMEM gate,
    ``pallas_logreg.py:151``, has no meaning here): B1 / B2 have a
    register-resident geometry. Elsewhere the packed path's body is B1's
    wide form and the update in tensor ops."""
    return step_geometry(dpp, c) is not None


# B3 and B1's wide form on Hopper (csrc/logreg.cu, ``masked_plan``,
# ``wide_plan``): 128-row tiles, pass (b)'s 128 columns a CTA, at most 16
# row ranges, the H100's SMs, pass (a)'s ring budget (two CTAs an SM) and
# the bytes of an R^T staging row and of a pass (b) stage
MASKED_ROWS = 128
_MASKED_COLS = 128
_MASKED_MAX_RANGES = 16
_SMS = 132
_MASKED_BUDGET_A = SMEM_LIMIT // 2 - 2048
_MASKED_LDR = MASKED_ROWS + 8
_MASKED_STAGE_B = 2 * STEP_ROWS * 128 + 2 * 64 * _MASKED_COLS * 2
#: classes a pass (a) CTA holds (one wgmma N); a lane's classes past it
#: take a cluster of CTAs, or past ``CLUSTER_MAX_CTAS`` of them two sweeps of
#: tiles of this width
CLASS_TILE = 256
#: the (NA, CPP) instantiations of B3's pass (a) to ``CLASS_TILE`` classes
#: (``LOGREG_MASKED_GEOMETRIES``)
MASKED_GEOMETRIES = frozenset([
    (64, 16), (64, 32), (64, 64), (128, 16), (128, 32), (128, 64), (128, 128), (256, 256),
])
#: B1's wide form: the packed path's features (``models/logistic.py``'s
#: cap, the JAX package's), and the scratch a launch may hold (as B4's f32
#: mode caps it; lanes and rows past it go into further launches)
WIDE_MAX_DPP = 512
WIDE_SCRATCH_BYTES = 1 << 31
#: the (NA, CPP) instantiations of the wide form's pass (a) to
#: ``CLASS_TILE`` classes (``LOGREG_WIDE_GEOMETRIES``)
WIDE_GEOMETRIES = frozenset([(128, 16), (128, 32), (128, 64), (128, 128), (256, 256)])
#: pass (a) past ``CLASS_TILE`` classes in clusters
#: (``masked_logits_cluster_kernel``): rows of A a tile, a CTA's threads,
#: the most CTAs a cluster (the portable size), a TMA box of A, the ring's
#: most sets (W^T resident) and most atoms (W^T streamed), and the class
#: slices N a CTA takes (``LOGREG_CLUSTER_WIDTHS``: N / 2 columns a
#: warpgroup)
CLUSTER_ROWS = 64
_CLUSTER_THREADS = 256
CLUSTER_MAX_CTAS = 8
_CLUSTER_BOX = CLUSTER_ROWS * 128
_CLUSTER_MAX_STAGES = 4
_CLUSTER_MAX_RING_W = 8
CLUSTER_SLICES = (160, 192, 224, 256)


def class_pitch(cp: int) -> int:
    """The columns a lane takes in the lane-major layout of B3 and of B1's
    wide form: ``cp`` rounded up to a power of two (at least 16) up to
    ``CLASS_TILE``; past it, to ``CLUSTER_MAX_CTAS`` x ``CLASS_TILE``, k x N
    for a cluster of k = ceil(cp / ``CLASS_TILE``) CTAs, each a slice of N
    columns (ceil(cp / k) rounded up to 32: in (128, 256]); past that a
    multiple of ``CLASS_TILE`` (the two sweeps)."""
    if cp > CLUSTER_MAX_CTAS * CLASS_TILE:
        return -(-cp // CLASS_TILE) * CLASS_TILE
    if cp > CLASS_TILE:
        k = -(-cp // CLASS_TILE)
        n = -(-cp // k)
        return k * (-(-n // 32) * 32)
    cpp = 16
    while cpp < cp:
        cpp *= 2
    return cpp


def _best_ranges(units: int, tiles: int) -> int:
    """Pass (b)'s row ranges P: the fewest among those whose waves of
    ``units`` CTAs a range take the least time (a wave's time being a
    range's share of ``tiles`` row tiles), at most 16 and ``tiles``."""
    best, best_waves = 1, -(-units // _SMS)
    for P in range(2, min(_MASKED_MAX_RANGES, tiles) + 1):
        waves = -(-units * P // _SMS)
        if waves * best < best_waves * P:
            best, best_waves = P, waves
    return best


def _pass_a_smem(na: int, tiled: bool) -> tuple:
    """Pass (a)'s ring stages and shared memory at ``na`` columns a CTA:
    two CTAs an SM with R^T staged over the ring at the end; the
    class-tiled pass, one CTA an SM, stages each class tile's R^T beside
    the ring (the producer is loading the next tile)."""
    stage = STEP_ROWS * 128 + na * 128
    staging = na * _MASKED_LDR * 2
    if tiled:
        stages = min(_STEP_MAX_STAGES, (SMEM_LIMIT - 2048 - staging) // stage)
        return stages, 1024 + stages * stage + staging + 1024
    stages = min(_STEP_MAX_STAGES, _MASKED_BUDGET_A // stage)
    return stages, 1024 + max(stages * stage, staging) + 1024


def _cluster_set(n: int, mt: int, ring_w: int) -> int:
    """A cluster ring stage's bytes: ``mt`` 64-row boxes of A with W^T
    resident; one box of A and one of the W^T slice (``n`` rows x 64
    features) with W^T streamed."""
    return _CLUSTER_BOX + n * 128 if ring_w else mt * _CLUSTER_BOX


def cluster_layout(n: int, mt: int, stages: int, ring_w: int = 0) -> int:
    """A pass (a) cluster CTA's shared memory (``cluster_layout`` in
    csrc/logreg.cu, byte for byte): 1 KB of mbarriers, the W^T slice (``mt``
    boxes of ``n`` rows x 64 features, bf16; none where it streams), the
    residual's staging tile ([n][64] bf16), two tiles' (max, sum) pairs of
    256 threads, ``stages`` ring stages (``_cluster_set``), and 1 KB to
    align the base."""
    return (1024 + (0 if ring_w else mt * n * 128) + n * 128 + 2 * _CLUSTER_THREADS * 16
            + stages * _cluster_set(n, mt, ring_w) + 1024)


def cluster_stages(n: int, mt: int, ring_w: int = 0) -> int:
    """The cluster ring's stages: as many as fit beside the rest, up to
    four sets with W^T resident (0 where none fits: it streams then) or
    eight atoms with it streamed."""
    most = _CLUSTER_MAX_RING_W if ring_w else _CLUSTER_MAX_STAGES
    free = max(0, SMEM_LIMIT - cluster_layout(n, mt, 0, ring_w))
    return min(most, free // _cluster_set(n, mt, ring_w))


def _pass_a_plan(cpp: int, na: int, mt: int, lanes: int, tiles: int) -> dict:
    """Pass (a)'s route (``pass_a_plan`` in csrc/logreg.cu): to
    ``CLASS_TILE`` classes ``na`` columns of lanes that share each A tile
    (``"lanes"``); past it, to ``CLUSTER_MAX_CTAS`` x ``CLASS_TILE``, a
    cluster of cl = ceil(cpp / ``CLASS_TILE``) CTAs a lane, each na = cpp /
    cl columns, its W^T slice resident where it, a ring set, the staging
    tile and the pairs fit a CTA (``"cluster"``), else streamed through the
    ring with A (``"cluster_ring"``, ``ring_w`` 1); its rows in
    ``ranges_a`` ranges: from one, each count whose waves of lanes x cl x
    ranges CTAs (one an SM), a wave's time being a range's share of the
    ``tiles`` 64-row tiles (a launch's fewest), take under 0.9 of the time
    of the count taken so far. Past that the two sweeps of 256-column class
    tiles (``"sweeps"``)."""
    if cpp <= CLASS_TILE:
        stages, smem = _pass_a_smem(na, False)
        return {"pass_a": "lanes", "na": na, "cl": 1, "ring_w": 0, "ranges_a": 1,
                "stages_a": stages, "smem_a": smem}
    if cpp <= CLUSTER_MAX_CTAS * CLASS_TILE:
        cl = -(-cpp // CLASS_TILE)
        n = cpp // cl
        ring_w, stages = 0, cluster_stages(n, mt)
        if stages < 1 or stages * mt >= 128:
            ring_w, stages = 1, cluster_stages(n, mt, 1)
        if stages >= 1 + ring_w:
            units = lanes * cl
            P, best = 1, -(-units // _SMS)
            for Q in range(2, min(_MASKED_MAX_RANGES, tiles) + 1):
                waves = -(-units * Q // _SMS)
                if 10 * waves * P < 9 * best * Q:
                    P, best = Q, waves
            return {"pass_a": "cluster_ring" if ring_w else "cluster", "na": n, "cl": cl,
                    "ring_w": ring_w, "ranges_a": P, "stages_a": stages,
                    "smem_a": cluster_layout(n, mt, stages, ring_w)}
    stages, smem = _pass_a_smem(CLASS_TILE, True)
    return {"pass_a": "sweeps", "na": CLASS_TILE, "cl": 1, "ring_w": 0, "ranges_a": 1,
            "stages_a": stages, "smem_a": smem}


def _pass_b_smem() -> tuple:
    stages = min(_STEP_MAX_STAGES, (SMEM_LIMIT - 2048) // _MASKED_STAGE_B)
    return stages, 1024 + stages * _MASKED_STAGE_B + 1024


def masked_plan(n_pad: int, dpp: int, cp: int, n_lanes: int) -> Optional[dict]:
    """B3's plan (``masked_plan`` in csrc/logreg.cu, field for field), or
    None where the kernels refuse the shape. Columns of R are lane-major
    (lane * cpp + class, cpp = ``class_pitch(cp)``); pass (a) by the route
    ``_pass_a_plan`` names (``pass_a``): ``na`` columns of lanes a CTA (64
    when 128 would leave SMs idle), past ``CLASS_TILE`` classes clusters of
    ``cl`` CTAs a lane, each a slice of ``na`` columns, over ``ranges_a``
    row ranges, or the two sweeps; pass (b) 128 features x 128 columns
    over one of ``ranges`` row ranges (``_best_ranges``). ``scratch`` is
    the bytes of W^T, R^T and the range partials."""
    if n_pad <= 0 or dpp <= 0 or dpp % 16 or cp <= 0 or cp % 16 or n_lanes <= 0:
        return None
    cpp = class_pitch(cp)
    row_tiles = -(-n_pad // MASKED_ROWS)
    cols = _align(n_lanes * cpp, _MASKED_COLS)
    na = 2 * _MASKED_COLS if cpp > _MASKED_COLS else _MASKED_COLS
    if cpp <= 64 and row_tiles * (cols // _MASKED_COLS) < _SMS:
        na = 64
    mt = -(-dpp // _STEP_ATOM)
    fb = (mt + 1) // 2
    best = _best_ranges(fb * (cols // _MASKED_COLS), row_tiles)
    pass_a = _pass_a_plan(cpp, na, mt, n_lanes, 2 * row_tiles)
    stages_b, smem_b = _pass_b_smem()
    rows_pad = row_tiles * MASKED_ROWS
    r_off = _align(cols * dpp * 2, 1024)
    part_off = r_off + _align(cols * rows_pad * 2, 1024)
    return {"cpp": cpp, **pass_a, "row_tiles": row_tiles, "cols": cols, "mt": mt, "fb": fb,
            "ranges": best, "stages_b": stages_b, "smem_b": smem_b,
            "scratch": part_off + best * dpp * cols * 4, "r_offset": r_off,
            "part_offset": part_off}


#: the fields of ``logreg_masked_plan``'s output, in order
MASKED_PLAN_FIELDS = ("cpp", "na", "cl", "ring_w", "row_tiles", "cols", "mt", "fb", "ranges",
                      "ranges_a", "stages_a", "stages_b", "smem_a", "smem_b", "scratch")


def masked_ranges(plan: dict, n_pad: int) -> list:
    """Pass (b)'s row ranges ``[(r0, r1), ...]`` in order: range p takes
    the 128-row tiles p T / P .. (p + 1) T / P - 1, clipped to n_pad."""
    T, P = plan["row_tiles"], plan["ranges"]
    return [(p * T // P * MASKED_ROWS, min(n_pad, (p + 1) * T // P * MASKED_ROWS))
            for p in range(P)]


def masked_grad_applicable(dpp: int, cp: int) -> bool:
    """Gate of the masked lane kernel: features tiled in both passes, so
    any dpp in 16s; classes padded to 16s, any number of them."""
    return dpp > 0 and dpp % 16 == 0 and cp > 0 and cp % 16 == 0


def _wide_bytes(dpp: int, cols: int, tiles: int, P: int) -> tuple:
    """(R^T's offset, the partials' offset, bytes in all) of a wide-form
    launch's scratch: W^T [cols][dpp] bf16, R^T [cols][128 tiles] bf16,
    the partials [P][dpp][cols] f32."""
    r_off = _align(cols * dpp * 2, 1024)
    part_off = r_off + _align(cols * tiles * MASKED_ROWS * 2, 1024)
    return r_off, part_off, part_off + P * dpp * cols * 4


def wide_plan(n_pad: int, dpp: int, c: int, S: int, n_wb: int,
              Tw: int = TRIAL_BLOCK) -> Optional[dict]:
    """B1's wide form's plan (``wide_plan`` in csrc/logreg.cu, field for
    field), or None where the kernels refuse the shape. The packed columns
    of a lane block (one split s of weight block wb: ``Tw`` trials, block
    index ``wb * S + s``) become ``Tw`` lanes of ``cpp = class_pitch(c)``
    lane-major columns, as in B3. A launch takes ``lb`` lane blocks over
    ``tiles`` row tiles, the fewest launches whose scratch (at one row
    range) fits ``WIDE_SCRATCH_BYTES``: rows are split only where one lane
    block over all rows does not fit, then lanes; the row chunks of a lane
    group add into the gradient in order. ``lb`` and ``tiles`` are a
    launch's most (``wide_launch`` gives each launch's own); ``ranges`` is
    pass (b)'s P in every launch (``_best_ranges`` over the smallest
    chunk's tiles, fewer where its partials would pass the cap); pass (a)
    takes ``_pass_a_plan``'s route at the most lanes and the smallest
    chunk's tiles."""
    if (n_pad <= 0 or dpp <= 0 or dpp % 16 or dpp > WIDE_MAX_DPP or c < 2 or S <= 0
            or n_wb <= 0 or Tw <= 0 or Tw % 16 or Tw > TRIAL_BLOCK):
        return None
    cpp = class_pitch(c)
    n_lb = n_wb * S
    row_tiles = -(-n_pad // MASKED_ROWS)
    mt = -(-dpp // _STEP_ATOM)
    fb = (mt + 1) // 2

    def launch_bytes(lb, R, P=1):
        return _wide_bytes(dpp, lb * Tw * cpp, -(-row_tiles // R), P)[2]

    R = 1  # row chunks
    while -(-row_tiles // R) > 65_535 or launch_bytes(1, R) > WIDE_SCRATCH_BYTES:
        if R == row_tiles:
            return None
        R += 1
    G = 1  # lane groups
    while launch_bytes(-(-n_lb // G), R) > WIDE_SCRATCH_BYTES:
        G += 1
    lb, tiles = -(-n_lb // G), -(-row_tiles // R)
    # P ranges: _best_ranges' count, fewer where its partials would not fit
    P = _best_ranges(fb * (lb * Tw * cpp // _MASKED_COLS), row_tiles // R)
    while P > 1 and launch_bytes(lb, R, P) > WIDE_SCRATCH_BYTES:
        P -= 1
    na = 2 * _MASKED_COLS if cpp > _MASKED_COLS else _MASKED_COLS
    pass_a = _pass_a_plan(cpp, na, mt, lb * Tw, 2 * (row_tiles // R))
    stages_b, smem_b = _pass_b_smem()
    r_off, part_off, total = _wide_bytes(dpp, lb * Tw * cpp, tiles, P)
    return {"cpp": cpp, **pass_a, "row_tiles": row_tiles, "n_lb": n_lb, "lb": lb,
            "lane_launches": G, "row_launches": R, "launches": G * R, "tiles": tiles,
            "mt": mt, "fb": fb, "ranges": P, "stages_b": stages_b, "smem_b": smem_b,
            "scratch": total, "r_offset": r_off, "part_offset": part_off}


#: the fields of ``logreg_wide_plan``'s output, in order
WIDE_PLAN_FIELDS = ("cpp", "na", "cl", "ring_w", "row_tiles", "n_lb", "lb", "lane_launches",
                    "row_launches", "launches", "tiles", "mt", "fb", "ranges", "ranges_a",
                    "stages_a", "stages_b", "smem_a", "smem_b", "scratch")


#: B1's fused wide form (``fused_wide_kernel``, csrc/logreg_fused.cu): the
#: ring's most row-tile sets, a CTA's threads, its row tile, its most row
#: ranges, and the (NC, L, KU, CL) instantiations in the plan's order of
#: preference (``LOGREG_FUSED_GEOMETRIES``): NC columns a warpgroup of L
#: lanes, KU feature atoms at most (a warpgroup's share of the gradient
#: holds every atom), CL CTAs a cluster, a pitch of 2 NC CL / L classes a lane
_FUSED_MAX_SETS = 4
_FUSED_THREADS = 256
FUSED_ROWS = 64
_FUSED_MAX_RANGES = 4
FUSED_GEOMETRIES = ((32, 8, 8, 1), (40, 8, 7, 1), (32, 4, 8, 1), (32, 2, 8, 1), (32, 1, 8, 1),
                    (40, 1, 7, 1), (56, 1, 5, 1), (64, 1, 4, 1), (32, 1, 8, 2), (40, 1, 7, 2),
                    (56, 1, 5, 2), (64, 1, 4, 2), (32, 1, 8, 4))


def fused_layout(nc: int, mt: int, stages: int) -> int:
    """A fused CTA's shared memory (``fused_layout`` in
    csrc/logreg_fused.cu, byte for byte): 1 KB of mbarriers, V^T of both warpgroups' classes,
    each one's residual of a tile, two tiles' softmax partials, ``stages``
    64-row tiles of ``mt`` atoms, and 1 KB to align the base."""
    return (1024 + 2 * mt * nc * 128 + nc * 256 + 2 * _FUSED_THREADS * 32
            + stages * mt * FUSED_ROWS * 128 + 1024)


def fused_stages(nc: int, mt: int) -> int:
    """The ring's row-tile sets: as many as fit beside the rest, up to four
    (the plan takes two at least)."""
    base = fused_layout(nc, mt, 0)
    return min(_FUSED_MAX_SETS, max(0, SMEM_LIMIT - base) // (mt * FUSED_ROWS * 128))


def fused_plan(n_pad: int, dpp: int, c: int, S: int, n_wb: int,
               Tw: int = TRIAL_BLOCK) -> Optional[dict]:
    """B1's fused wide form's plan (``fused_plan`` in csrc/logreg_fused.cu,
    field for field), or None where it has no geometry: the shape then takes the
    two passes (``wide_plan``). A cluster of ``cl`` CTAs owns ``L`` lanes
    (trials of one split of one weight block) at a pitch of ``2 nc cl / L``
    classes, the least pitch of ``FUSED_GEOMETRIES`` that holds c; each
    warpgroup owns a part of the classes (``nc`` columns) over every feature
    atom, in 64-row tiles. One CTA (cl 1) fits dpp <= 512 to 64 classes,
    dpp <= 448 to 80, dpp <= 320 to 112 and dpp <= 256 to 128 (a
    warpgroup's share of the gradient over every atom); clusters of 2 and
    4 CTAs take the lanes to 256 classes at every dpp. ``blocks`` is the
    CTAs, ``cl`` a column block. ``ranges`` row ranges (P <= 4): from P =
    1, each Q = 2, 3, 4 whose partials fit ``WIDE_SCRATCH_BYTES`` is taken
    where its waves of ``blocks * Q`` CTAs, a wave's time being a range's
    share of the rows, take under 0.9 of the time of the P taken so far (a
    range more costs each CTA its prologue and the partials their sum).
    The scratch: ``vt`` bytes of W3 transposed (each lane's classes in rows
    of the padded features, bf16, which the CTAs read whole), then at P > 1
    P partials of G3's size, added in range order: no per-row residual
    leaves the chip."""
    if (n_pad <= 0 or dpp <= 0 or dpp % 16 or dpp > WIDE_MAX_DPP or c < 2 or S <= 0
            or n_wb <= 0 or Tw <= 0 or Tw % 16 or Tw > TRIAL_BLOCK):
        return None
    mt = -(-dpp // _STEP_ATOM)
    pick = None
    for nc, L, ku, cl in FUSED_GEOMETRIES:
        if 2 * nc * cl // L < c or Tw % L or mt > ku or fused_stages(nc, mt) < 2:
            continue
        if pick is None or nc * cl * pick[1] < pick[0] * pick[3] * L:
            pick = (nc, L, ku, cl)
    if pick is None:
        return None
    nc, L, ku, cl = pick
    row_tiles = -(-n_pad // FUSED_ROWS)
    blocks = n_wb * S * Tw // L * cl
    g3 = n_wb * dpp * c * S * Tw * 4
    P, best_waves = 1, -(-blocks // _SMS)
    for Q in range(2, min(_FUSED_MAX_RANGES, row_tiles) + 1):
        waves = -(-blocks * Q // _SMS)
        if Q * g3 <= WIDE_SCRATCH_BYTES and 10 * waves * P < 9 * best_waves * Q:
            P, best_waves = Q, waves
    stages = fused_stages(nc, mt)
    pitch = 2 * nc * cl // L
    vt = _align(n_wb * S * Tw * pitch * mt * _STEP_ATOM * 2, 1024)
    return {"nc": nc, "L": L, "ku": ku, "cl": cl, "pitch": pitch, "mt": mt,
            "row_tiles": row_tiles, "blocks": blocks, "ranges": P, "stages": stages,
            "smem": fused_layout(nc, mt, stages), "vt": vt,
            "scratch": vt + (P * g3 if P > 1 else 0)}


#: the fields of ``logreg_fused_plan``'s output, in order
FUSED_PLAN_FIELDS = ("nc", "L", "ku", "cl", "pitch", "mt", "row_tiles", "blocks", "ranges",
                     "stages", "smem", "vt", "scratch")


def route_plan(n_pad: int, dpp: int, c: int, S: int, n_wb: int,
               Tw: int = TRIAL_BLOCK) -> tuple:
    """The body ``packed_softmax_grad`` runs on the card, by shape alone,
    and its plan: ``("resident", step_geometry)`` where B1 / B2 have a
    register-resident geometry, else ``("fused", fused_plan)`` where the
    fused form has one, else ``("two_pass", wide_plan)`` where the two
    passes have one (``fused_plan`` says where: past 256 classes), else
    ``(None, None)`` (the card refuses the shape)."""
    geo = step_geometry(dpp, c)
    if geo is not None:
        return "resident", geo
    plan = fused_plan(n_pad, dpp, c, S, n_wb, Tw)
    if plan is not None:
        return "fused", plan
    plan = wide_plan(n_pad, dpp, c, S, n_wb, Tw)
    return ("two_pass", plan) if plan is not None else (None, None)


def wide_scratch_bytes(n_pad: int, dpp: int, c: int, S: int, n_wb: int,
                       Tw: int = TRIAL_BLOCK) -> int:
    """Device scratch of one ``packed_softmax_grad`` call on the card: the
    fused form's transposed weights and row-range partials, the two passes' buffer,
    none for the register-resident body or a refused shape."""
    route, plan = route_plan(n_pad, dpp, c, S, n_wb, Tw)
    return plan["scratch"] if route in ("fused", "two_pass") else 0


def wide_launch(plan: dict, i: int) -> tuple:
    """Launch ``i``'s lane blocks ``[lb0, lb1)`` and row tiles ``[t0, t1)``
    (``wide_launch`` in csrc/logreg.cu): lane group i // R, row chunk
    i % R, each cut as evenly as floor division cuts."""
    G, R = plan["lane_launches"], plan["row_launches"]
    g, r = divmod(i, R)
    n_lb, T = plan["n_lb"], plan["row_tiles"]
    return g * n_lb // G, (g + 1) * n_lb // G, r * T // R, (r + 1) * T // R


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
        lib.logreg_wide_plan.argtypes = [I] * 6 + [P]
        lib.logreg_wide_plan.restype = I
        lib.logreg_wide_softmax_grad.argtypes = (
            [P] * 6 + [ctypes.c_longlong] + [I] * 7 + [P]
        )
        lib.logreg_wide_softmax_grad.restype = I
        _lib_handle = lib
    return _lib_handle


_fused_lib_handle: Optional[ctypes.CDLL] = None


def _fused_lib() -> ctypes.CDLL:
    """The built csrc/logreg_fused.cu (B1's fused wide form; a source of
    its own, so that its build runs beside logreg.cu's) with its C
    signatures declared."""
    global _fused_lib_handle
    if _fused_lib_handle is None:
        from .cuda_build import load

        lib = load("logreg_fused")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.logreg_fused_plan.argtypes = [I] * 6 + [P]
        lib.logreg_fused_plan.restype = I
        lib.logreg_fused_softmax_grad.argtypes = (
            [P] * 6 + [ctypes.c_longlong] + [I] * 6 + [P]
        )
        lib.logreg_fused_softmax_grad.restype = I
        _fused_lib_handle = lib
    return _fused_lib_handle


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

    On the card, by shape alone (``route_plan``): the register-resident
    body where ``step_geometry`` has a geometry (one launch, counted in
    ``LAUNCHES["packed_softmax_grad"]``), else the fused wide form where
    ``fused_plan`` has one (one C call, counted in
    ``LAUNCHES["packed_softmax_grad_fused"]``), else the two passes,
    ``wide_plan``'s launches on one scratch buffer (each counted in
    ``LAUNCHES["packed_softmax_grad_wide"]``, and in ``PASS_A_LAUNCHES``
    under its pass (a) route).
    """
    if not _on_card(Ab, W3, y2, WSP):
        return packed_softmax_grad_reference(Ab, W3, y2, WSP, c=c, S=S, Tw=Tw)
    n_pad, dpp = Ab.shape
    n_wb, NB = W3.shape[0], c * S * Tw
    _check("Ab", Ab, torch.bfloat16, (n_pad, dpp))
    _check("W3", W3, torch.bfloat16, (n_wb, dpp, NB))
    _check("y2", y2, torch.int32, (n_pad, 1))
    _check("WSP", WSP, torch.float32, (n_pad, S))
    route, plan = route_plan(n_pad, dpp, c, S, n_wb, Tw)
    if route == "fused":
        return _packed_softmax_grad_fused(Ab, W3, y2, WSP, plan, c=c, S=S, Tw=Tw)
    if route == "two_pass":
        return _packed_softmax_grad_wide(Ab, W3, y2, WSP, plan, c=c, S=S, Tw=Tw)
    geo = plan
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


def _packed_softmax_grad_fused(Ab, W3, y2, WSP, plan, *, c: int, S: int, Tw: int):
    """B1's fused wide form on the card: one C call (W3 transposed, the
    fused kernel, and at P > 1 the in-order sum of the ranges' partials)."""
    n_pad, dpp = Ab.shape
    n_wb = W3.shape[0]
    G3 = torch.empty((n_wb, dpp, c * S * Tw), dtype=torch.float32, device=Ab.device)
    scratch = torch.empty(plan["scratch"], dtype=torch.uint8, device=Ab.device)
    with torch.cuda.device(Ab.device):
        _launch(_fused_lib().logreg_fused_softmax_grad, _ptr(Ab), _ptr(W3), _ptr(y2), _ptr(WSP),
                _ptr(G3), _ptr(scratch), plan["scratch"], n_pad, dpp, c, S, n_wb, Tw,
                device=Ab.device)
    LAUNCHES["packed_softmax_grad_fused"] += 1
    return G3


def _packed_softmax_grad_wide(Ab, W3, y2, WSP, plan, *, c: int, S: int, Tw: int):
    """B1's wide form on the card: ``wide_plan``'s launches in order, each
    one C call (W^T of its lane blocks, pass (a), pass (b), the range sum
    into G3, added to it after a lane group's first row chunk)."""
    n_pad, dpp = Ab.shape
    n_wb = W3.shape[0]
    G3 = torch.empty((n_wb, dpp, c * S * Tw), dtype=torch.float32, device=Ab.device)
    scratch = torch.empty(plan["scratch"], dtype=torch.uint8, device=Ab.device)
    with torch.cuda.device(Ab.device):
        for i in range(plan["launches"]):
            _launch(_lib().logreg_wide_softmax_grad, _ptr(Ab), _ptr(W3), _ptr(y2),
                    _ptr(WSP), _ptr(G3), _ptr(scratch), plan["scratch"], n_pad, dpp, c, S,
                    n_wb, Tw, i, device=Ab.device)
            LAUNCHES["packed_softmax_grad_wide"] += 1
            PASS_A_LAUNCHES["packed_softmax_grad_wide_" + plan["pass_a"]] += 1
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
    plan's size (W^T, the bf16 residual R^T, the row ranges' partials),
    counted in ``LAUNCHES["masked_softmax_grad"]``, and in
    ``PASS_A_LAUNCHES`` under its pass (a) route.
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
    PASS_A_LAUNCHES["masked_softmax_grad_" + plan["pass_a"]] += 1
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
