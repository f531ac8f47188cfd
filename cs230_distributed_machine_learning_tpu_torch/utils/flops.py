"""Analytical FLOP accounting and MFU on the CUDA card.

Port of the JAX package's ``utils/flops.py``. Kernels publish
``macs_estimate(n, d, static)``, the model-analytical multiply-accumulate
count of ONE (trial, split) fit, and the accounting combines it with wall
clock and the card's peak rate:

    mfu = (2 * macs * n_splits * n_trials) / wall_s / peak_flops

This is *model* FLOP utilization: only the FLOPs the model semantically
requires count, not implementation overheads (padding, recompute, masked
lanes), so it is comparable across implementations.

The peaks are NVIDIA's published dense BF16 tensor-core rates of each
H100 part; MFU is None on the CPU and on a card not in the table.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

#: dense bf16 tensor-core FLOP/s by device-name substring (NVIDIA's data
#: sheets, without sparsity), most specific first
_PEAKS = (
    ("h100 nvl", 835e12),
    ("h100 pcie", 756e12),
    ("h100 80gb hbm3", 989.4e12),  # H100 SXM5
    ("h100 sxm", 989.4e12),
)


def device_peak_flops() -> Optional[float]:
    """Peak bf16 FLOP/s of CUDA device 0, or None on the CPU or an unknown
    card (MFU is not a meaningful metric for host execution)."""
    import torch

    try:
        if not torch.cuda.is_available():
            return None
        name = torch.cuda.get_device_name(0).lower()
    except Exception:  # noqa: BLE001 — an unreachable card has no peak
        return None
    for sub, peak in _PEAKS:
        if sub in name:
            return peak
    return None


def device_memory_stats() -> Dict[str, Any]:
    """CUDA device 0's memory in the JAX ``memory_stats()`` keys:
    ``bytes_in_use`` (the caching allocator's allocated bytes),
    ``peak_bytes_in_use`` (its high-water since the last
    ``reset_peak_memory_stats``) and ``bytes_limit`` (the card's total).
    ``{}`` on the CPU or when no card is reachable. The one shared reader
    behind the HBM gauge, ``TrialRunResult.hbm_peak_bytes``, the resource
    sampler and ``GET /healthz``."""
    import torch

    try:
        if not torch.cuda.is_available():
            return {}
        stats = torch.cuda.memory_stats(0)
        _free, total = torch.cuda.mem_get_info(0)
    except Exception:  # noqa: BLE001 — stats are best-effort everywhere
        return {}
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(total),
    }


def analytical_flops(
    kernel: Any,
    static: Dict[str, Any],
    n: int,
    d: int,
    n_splits: int,
    n_trials: int,
) -> Optional[float]:
    """Total model FLOPs of a job: 2 * per-(trial,split) MACs * splits *
    trials. None when the kernel has no analytical estimate."""
    if not hasattr(kernel, "macs_estimate"):
        return None
    per = float(kernel.macs_estimate(n, d, static))
    return 2.0 * per * max(n_splits, 1) * max(n_trials, 1)


def stratified_by(population, key_fn, n_samples: int):
    """Evenly spaced quantile positions of ``population`` sorted by
    ``key_fn``: the harnesses' shared subsampling for extrapolated sklearn
    denominators (per-trial cost varies strongly with e.g. C under
    loguniform, so random draws under-represent the tails)."""
    import numpy as np

    srt = sorted(population, key=key_fn)
    pos = (
        np.linspace(0, len(srt) - 1, min(n_samples, len(srt))).round().astype(int)
    )
    return [srt[i] for i in pos]


def mfu(
    flops: Optional[float], wall_s: float, n_devices: int = 1
) -> Optional[float]:
    """Achieved fraction of the card's peak; None off the card or without
    an analytical FLOPs figure. ``n_devices`` scales the peak for work that
    ran across several cards."""
    peak = device_peak_flops()
    if flops is None or peak is None or wall_s <= 0:
        return None
    return flops / wall_s / (peak * max(int(n_devices), 1))
