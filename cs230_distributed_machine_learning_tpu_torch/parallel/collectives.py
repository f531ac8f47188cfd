"""Cross-trial aggregation: on the host, or over the ranks of a trial mesh.

Port of the JAX package's ``parallel/collectives.py``. Without a mesh the
scores are host scalars already and the argmax runs on the host. Over a
mesh (parallel/mesh.py) each rank holds a contiguous shard of the trial
vector on its device and the reduction is a ``torch.distributed``
collective:

- :func:`best_trial`: each rank takes its local argmax, the (score, global
  index) pairs are all-gathered, and the first maximum wins (sklearn's
  ``best_index_`` tie rule); non-finite and padding lanes rank last. The
  trial engine calls it on every sharded chunk (``_chunk_best`` in JAX)
  and the executor marks the winner (``device_argmax``).
- :func:`topk_trials`: the k best trials, descending, ties to the lower
  index (``lax.top_k``'s order).
- :func:`fold_mean_via_psum`: the mean of K fold scores from a sum
  all-reduce over the ranks' fold shards.

On a 2-D (trials, data) mesh each of them runs over the rank's trial
group: the ranks of one data group hold the same lanes and the same
scores, so nothing is counted twice.

Each computes on the rank's device (the card, where the ranks have one);
only the gathered pairs move between ranks.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .distributed import _lanes, all_gather_tensor


def _host_best(mean_scores: Sequence[float]) -> Tuple[int, float]:
    s = np.asarray(mean_scores, np.float64)
    idx = int(np.argmax(s))
    return idx, float(s[idx])


def _local(values, mesh, dtype=torch.float32) -> torch.Tensor:
    if isinstance(values, torch.Tensor):
        return values.to(mesh.device, dtype)
    return torch.as_tensor(np.asarray(values), dtype=dtype, device=mesh.device)


def best_trial(mean_scores, mesh=None, valid_mask=None, offset: int = 0
               ) -> Tuple[int, float]:
    """argmax of the per-trial score vector, first index on ties. Returns
    (index, score) as host numbers.

    Without a mesh, ``mean_scores`` is the whole vector and the argmax runs
    on the host (the coordinator's ranking of collected results). With a
    mesh, ``mean_scores`` is this rank's shard, whose first trial has the
    global index ``offset``; ``valid_mask`` (the shard's) drops padding
    lanes. Non-finite scores rank last; when no lane is finite the result
    is the first lane's index with score -inf. A collective."""
    if mesh is None:
        return _host_best(mean_scores)
    mesh = _lanes(mesh)
    s = _local(mean_scores, mesh)
    keep = torch.isfinite(s)
    if valid_mask is not None:
        keep &= _local(valid_mask, mesh, torch.bool)
    s = torch.where(keep, s, torch.full_like(s, float("-inf")))
    if s.numel():
        i = int(torch.argmax(s).item())  # the first max within the shard
        pair = torch.tensor([[float(s[i].item()), float(offset + i)]], dtype=torch.float64)
    else:
        pair = torch.tensor([[float("-inf"), float("inf")]], dtype=torch.float64)
    pairs = all_gather_tensor(pair, mesh).cpu().numpy()
    best = max(range(len(pairs)), key=lambda r: (pairs[r, 0], -pairs[r, 1]))
    score, idx = pairs[best]
    if not np.isfinite(idx):
        idx = 0.0
    return int(idx), float(score)


def topk_trials(mean_scores, k: int, mesh=None, offset: int = 0):
    """Top-k trial (indices, scores), descending, equal scores in index
    order. Without a mesh on the whole vector; with one on each rank's
    shard (global index ``offset`` for its first trial), gathered."""
    if mesh is None:
        s = torch.as_tensor(np.asarray(mean_scores), dtype=torch.float32)
        order = torch.sort(-s, stable=True).indices[:k]
        return order.numpy().astype(np.int32), s[order].numpy()
    mesh = _lanes(mesh)
    s = _local(mean_scores, mesh)
    kk = min(int(k), int(s.numel()))
    order = torch.sort(-s, stable=True).indices[:kk]
    cand = torch.stack([s[order].double(), (order + int(offset)).double()], dim=1)
    if kk < k:  # ranks with fewer lanes pad with -inf, never chosen first
        pad = torch.tensor([[float("-inf"), float("inf")]] * (k - kk), dtype=torch.float64,
                           device=cand.device)
        cand = torch.cat([cand, pad])
    allc = all_gather_tensor(cand.cpu(), mesh).cpu().numpy()
    rows = sorted(range(len(allc)), key=lambda r: (-allc[r, 0], allc[r, 1]))[:k]
    return (allc[rows, 1].astype(np.int32), allc[rows, 0].astype(np.float32))


def fold_mean_via_psum(fold_scores, mesh) -> float:
    """Mean of K fold scores: each rank sums its contiguous slice of the K
    folds on its device, a sum all-reduce adds the slices, and the total
    is divided by K (JAX: a ``psum`` under ``shard_map``). K must divide
    by the mesh size."""
    import torch.distributed as dist

    from .distributed import _comm_device

    mesh = _lanes(mesh)
    s = np.asarray(fold_scores, np.float32).reshape(-1)
    n = int(mesh.world_size)
    k = s.shape[0]
    if k % n:
        raise ValueError(f"fold count {k} must divide by the mesh size {n}")
    lo, hi = mesh.shard(k)
    part = torch.as_tensor(s[lo:hi], device=mesh.device).sum().reshape(1)
    part = part.to(_comm_device(mesh.group))
    dist.all_reduce(part, op=dist.ReduceOp.SUM, group=mesh.group)
    return float((part / k).item())
