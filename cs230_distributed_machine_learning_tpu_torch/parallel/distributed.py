"""Multi-process runtime on ``torch.distributed``: one rank a device.

Port of the JAX package's ``parallel/distributed.py``. The JAX runtime
joins one multi-controller program (``jax.distributed.initialize``) whose
mesh spans hosts; here every rank is a process with one device, joined in
a ``torch.distributed`` process group:

- :func:`init_distributed` joins the group over TCP (``host:port``
  rendezvous, as in JAX). The backend rule: ``nccl`` when the ranks run on
  CUDA and each local rank has a card of its own; ``gloo`` when ranks
  share a card or run on the CPU. ``backend=`` overrides the rule. The
  chosen backend is logged and returned; a failed NCCL join raises and is
  never retried on gloo.
- :func:`broadcast_json` is the control plane's fan-out: process 0 (the
  only one talking REST) replicates each task batch to every rank, so all
  of them enter the same collectives in lockstep. The payload is padded to
  power-of-two buckets of at least ``_MIN_BUCKET`` bytes, its length
  broadcast first, as in JAX.
- :func:`fetch` assembles trial-sharded outputs on every rank: an
  all-gather over the ranks' equal shards (over the trial group on a 2-D
  mesh: the ranks of a data group hold the same lanes). Under gloo the
  shards are gathered as host tensors, after one device-to-host copy
  (:func:`prefetch_async`); under NCCL on the card.
- :func:`data_all_reduce` sums a row-sharded fit's row sums over the data
  group of a 2-D mesh, and :func:`data_all_gather_rows` assembles the
  rows of a per-row output in row order (the scorers that are not row
  sums). Under gloo a card tensor goes to pinned host memory and back
  explicitly, as in :func:`fetch`.

Every call here is a collective where the group has more than one rank:
every rank must make the same calls in the same order.
"""

from __future__ import annotations

import datetime
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..utils.logging import get_logger

logger = get_logger("tpuml.distributed")

#: seconds a rendezvous or a collective may wait for the other ranks
#: before it raises, unless ``init_distributed(timeout_s=)`` says otherwise
DEFAULT_TIMEOUT_S = 600.0

#: the group's collective timeout, as ``init_distributed`` set it; the
#: sub-groups of a 2-D mesh take the same
_TIMEOUT_S = DEFAULT_TIMEOUT_S

#: floor of the broadcast payload bucket: recurring small task batches all
#: land in one bucket (JAX ``distributed.py``)
_MIN_BUCKET = 4096


def choose_backend(device_type: str, local_world_size: int,
                   n_cards: Optional[int] = None) -> str:
    """``nccl`` when the ranks run on CUDA and each of the host's
    ``local_world_size`` ranks has a card of its own, else ``gloo`` (ranks
    sharing a card, or on the CPU)."""
    if device_type != "cuda":
        return "gloo"
    if n_cards is None:
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return "nccl" if n_cards >= max(int(local_world_size), 1) else "gloo"


def init_distributed(coordinator_address: str, num_processes: int, process_id: int, *,
                     backend: Optional[str] = None, device: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """Join the process group (idempotent per process) and return its
    backend. ``coordinator_address`` is the rendezvous ``host:port``
    (rank 0 listens there), not the REST url. ``device`` says where the
    ranks run: None is the card, ``"cpu"`` the host. The backend rule
    counts the ranks on this host from ``LOCAL_WORLD_SIZE``, else takes
    all ``num_processes`` to share one host. A rendezvous or
    collective that waits past ``timeout_s`` raises instead of hanging."""
    import torch.distributed as dist

    global _TIMEOUT_S
    if dist.is_initialized():
        return str(dist.get_backend())
    _TIMEOUT_S = float(timeout_s)
    local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    device_type = "cpu" if device == "cpu" else "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a rank found no CUDA card: pass device='cpu' to run the ranks "
                           "on the host")
    chosen = backend or choose_backend(device_type, local_world_size)
    addr = coordinator_address
    if "://" not in addr:
        addr = f"tcp://{addr}"
    timeout = datetime.timedelta(seconds=timeout_s)
    logger.info("Joining a %d-rank %s group at %s as rank %d", num_processes, chosen, addr,
                process_id)
    dist.init_process_group(chosen, init_method=addr, world_size=int(num_processes),
                            rank=int(process_id), timeout=timeout)
    return chosen


def group_timeout() -> datetime.timedelta:
    """The collective timeout for a sub-group: the default group's."""
    return datetime.timedelta(seconds=_TIMEOUT_S)


def _group_of(mesh):
    return None if mesh is None else mesh.group


def _lanes(mesh):
    """The mesh the trial lanes are sharded over: a 2-D mesh's trial
    group, else the mesh itself."""
    if mesh is not None and int(getattr(mesh, "data_size", 1)) > 1:
        return mesh.trial_view()
    return mesh


def process_index(mesh=None) -> int:
    import torch.distributed as dist

    if not dist.is_initialized():
        return 0
    return int(dist.get_rank(_group_of(mesh)))


def process_count(mesh=None) -> int:
    import torch.distributed as dist

    if not dist.is_initialized():
        return 1
    return int(dist.get_world_size(_group_of(mesh)))


def is_primary(mesh=None) -> bool:
    """True on the one process that owns the REST control plane."""
    return process_index(mesh) == 0


def is_multiprocess(mesh=None) -> bool:
    return process_count(mesh) > 1


def _comm_device(group) -> torch.device:
    """Where a collective's tensors must live: the rank's card under NCCL,
    the host otherwise."""
    import torch.distributed as dist

    if str(dist.get_backend(group)) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def prefetch_async(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Start a non-blocking device-to-host copy of every card tensor of
    ``tree`` into pinned memory and return the host tensors (host tensors
    pass through). The copies ride the current stream: synchronize it
    before reading them."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, torch.Tensor) and v.device.type == "cuda":
            host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host.copy_(v, non_blocking=True)
            out[k] = host
        else:
            out[k] = v
    return out


def all_gather_tensor(t: torch.Tensor, mesh) -> torch.Tensor:
    """The ranks' equal-shaped tensors concatenated along axis 0, on every
    rank, on the communication device (the card under NCCL, else the
    host)."""
    import torch.distributed as dist

    group = _group_of(mesh)
    dev = _comm_device(group)
    t = t.to(dev).contiguous()
    n = dist.get_world_size(group)
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=0)


def fetch(tree: Dict[str, Any], mesh=None) -> Dict[str, np.ndarray]:
    """Device to host: numpy leaves of an output dict. Without a mesh (or
    with one rank) each leaf is read directly; over a mesh each leaf is a
    rank's shard of the trial axis and comes back whole on every rank (one
    all-gather a leaf, in sorted key order). A collective: every rank must
    fetch the same keys in the same order. On a 2-D mesh the gather runs
    over the rank's trial group."""
    mesh = _lanes(mesh)
    if mesh is None or process_count(mesh) <= 1:
        return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                for k, v in tree.items()}
    group = _group_of(mesh)
    keys = sorted(tree)
    if _comm_device(group).type == "cpu":
        host = prefetch_async({k: tree[k] for k in keys})
        if any(isinstance(v, torch.Tensor) and v.device.type == "cuda" for v in tree.values()):
            torch.cuda.current_stream().synchronize()
        return {k: all_gather_tensor(host[k], mesh).numpy() for k in keys}
    return {k: all_gather_tensor(tree[k], mesh).cpu().numpy() for k in keys}


def _data_mesh(mesh):
    """The 2-D mesh behind ``mesh`` (a TrialMesh or a RowShard), or None
    without a data axis."""
    mesh = getattr(mesh, "mesh", mesh)
    if mesh is None or int(getattr(mesh, "data_size", 1)) <= 1:
        return None
    return mesh


def _to_comm(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` where the group's collectives take it: on the card under
    NCCL, else on the host (a card tensor through pinned memory, its
    stream synchronized before the read)."""
    dev = _comm_device(group)
    if dev.type == "cpu" and t.device.type == "cuda":
        host = prefetch_async({"t": t.contiguous()})["t"]
        torch.cuda.current_stream().synchronize()
        return host
    return t.to(dev).contiguous()


def data_all_reduce(t: torch.Tensor, mesh) -> torch.Tensor:
    """The SUM of ``t`` over the data group of a 2-D mesh (``mesh`` a
    TrialMesh or a RowShard), on ``t``'s device; ``t`` itself when there
    is no data axis. Every rank of a data group ends with the same bits
    (gloo's ring reduces each chunk once and passes it on). A collective
    of the data group."""
    m = _data_mesh(mesh)
    if m is None:
        return t
    import torch.distributed as dist

    buf = _to_comm(t, m.data_group)
    if buf is t:
        buf = t.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=m.data_group)
    return buf.to(t.device)


def data_all_gather_rows(t: torch.Tensor, shard, dim: int = -1) -> torch.Tensor:
    """The whole table's rows of a per-row output: ``t`` holds this rank's
    rows ``[shard.lo, shard.hi)`` along ``dim``; every data rank's rows
    come back concatenated in row order, on ``t``'s device. The shards are
    padded to the largest for the all-gather and the padding dropped.
    ``t`` itself when there is no data axis. A collective of the data
    group."""
    m = _data_mesh(shard)
    if m is None:
        return t
    import torch.distributed as dist

    dim = dim % t.dim()
    ranges = shard.ranges()
    width = max(hi - lo for lo, hi in ranges)
    pad = width - t.shape[dim]
    if pad:
        shape = list(t.shape)
        shape[dim] = pad
        t_pad = torch.cat([t, t.new_zeros(shape)], dim=dim)
    else:
        t_pad = t
    buf = _to_comm(t_pad, m.data_group)
    parts = [torch.empty_like(buf) for _ in ranges]
    dist.all_gather(parts, buf, group=m.data_group)
    rows = [p.narrow(dim, 0, hi - lo) for p, (lo, hi) in zip(parts, ranges)]
    return torch.cat(rows, dim=dim).to(t.device)


def all_gather_ints(values, mesh=None) -> np.ndarray:
    """Each rank's int64 vector (equal lengths) stacked ``[ranks, n]``."""
    arr = torch.as_tensor(np.asarray(values, np.int64).reshape(-1))
    n = process_count(mesh)
    if n <= 1:
        return arr.numpy()[None, :]
    return all_gather_tensor(arr, mesh).cpu().numpy().reshape(n, -1)


class PeerRankFailed(RuntimeError):
    """Another rank failed its part of a batch that this rank's part
    passed: the batch fails on every rank (:func:`agree`)."""


#: what a collective raises when a peer is gone: gloo reports a closed
#: connection (or its timeout) as a bare ``RuntimeError``, and
#: torch.distributed's own errors (``DistBackendError``, ``DistNetworkError``)
#: derive from it. An argument or payload fault (``TypeError``,
#: ``ValueError``, ...) is none of these and goes up as it is
LOST_PEER_ERRORS = (RuntimeError,)


class LockstepLostError(RuntimeError):
    """A rank failed between a batch's collectives: its siblings may be
    blocked in one it will never enter, so the slice must be relaunched."""


def agree(ok: bool, mesh=None) -> None:
    """The ranks' verdict on their rank-local part of a batch, before its
    first result collective: one all-gather of a flag. A rank whose own part
    failed re-raises its own error after this call; every other rank raises
    :class:`PeerRankFailed` when any rank failed. So a batch that fails on
    one rank fails on all of them, at the same point, and no rank enters a
    collective its siblings skip. A collective; when it fails itself (a
    rank was lost: gloo reports the closed connection) it raises
    :class:`LockstepLostError`, never a failure of the batch's tasks."""
    try:
        flags = all_gather_ints([0 if ok else 1], mesh).reshape(-1)
    except LOST_PEER_ERRORS as e:
        raise LockstepLostError(f"a rank of the trial mesh was lost at the batch's "
                                f"agreement: {e}") from e
    if ok and flags.any():
        raise PeerRankFailed(
            f"rank(s) {[int(r) for r in np.flatnonzero(flags)]} of the trial mesh failed "
            "their part of the batch")


def broadcast_json(obj: Any = None, mesh=None) -> Any:
    """Replicate ``obj`` (JSON-serializable) from rank 0 to every rank and
    return it; the other ranks' ``obj`` is ignored. The length goes first,
    then the payload padded to a power-of-two bucket of at least
    ``_MIN_BUCKET`` bytes. A collective."""
    import torch.distributed as dist

    if not dist.is_initialized() or process_count(mesh) <= 1:
        return json.loads(json.dumps(obj))
    group = _group_of(mesh)
    dev = _comm_device(group)
    src = dist.get_global_rank(group, 0) if group is not None else 0
    if is_primary(mesh):
        payload = json.dumps(obj).encode("utf-8")
    else:
        payload = b""
    n = torch.tensor([len(payload)], dtype=torch.int64, device=dev)
    dist.broadcast(n, src=src, group=group)
    n_bytes = int(n.item())
    bucket = max(_MIN_BUCKET, 1 << max(n_bytes - 1, 0).bit_length())
    buf = torch.zeros(bucket, dtype=torch.uint8)
    if payload:
        buf[: len(payload)] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    buf = buf.to(dev)
    dist.broadcast(buf, src=src, group=group)
    return json.loads(bytes(buf[:n_bytes].cpu().numpy()).decode("utf-8"))


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
