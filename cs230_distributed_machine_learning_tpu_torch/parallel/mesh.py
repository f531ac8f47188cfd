"""The trial mesh: a set of ranks, one process and one device each.

Port of the JAX package's ``parallel/mesh.py``. There a mesh is many
devices driven by one process (``jax.sharding.Mesh`` over a ``trials``
axis, or ``(trials, data)``); here it is PyTorch's own idiom, a
``torch.distributed`` process group whose every rank owns one device. The
trial engine shards each trial chunk over the ranks in contiguous slices
(parallel/trial_map.py), and the collectives (parallel/collectives.py,
parallel/distributed.py) reduce and gather over the group.

A 2-D mesh (``trial_mesh(data_parallel=k)``, JAX ``trial_mesh``'s
``data_parallel``) puts the W ranks on a (W // k) x k grid: rank r has the
trial coordinate ``r // k`` and the data coordinate ``r % k``. The ranks
of one trial coordinate form a ``data_group`` and split a row-sharded
bucket's rows (``row_range``), reducing its row sums over that group; the
ranks of one data coordinate form a ``trial_group`` and split its lanes.
Buckets that are not row-sharded run on the flat trial axis of all W ranks
(``flat()``), as the JAX package's chunked protocol runs replicated.

A mesh of world size 1 is treated as no mesh (the engine's single-device
path), as the JAX engine drops a one-device mesh.
"""

from __future__ import annotations

import dataclasses
import socket
from typing import Any, Dict, Optional, Tuple

import torch

#: the trial axis of a trial mesh
TRIAL_AXIS = "trials"
#: the row axis of a 2-D mesh
DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class TrialMesh:
    """One rank's view of a trial mesh: its process group (None is the
    default group), the group's size, this rank, the rank's device, how
    many of the group's ranks run on that device and so split its memory,
    and on a 2-D mesh the size of the data axis with the rank's two
    sub-groups (``trial_group``: the ranks of its data coordinate;
    ``data_group``: the ranks of its trial coordinate)."""

    group: Any
    world_size: int
    rank: int
    device: torch.device
    axis: str = TRIAL_AXIS
    device_share: int = 1
    data_size: int = 1
    trial_group: Any = None
    data_group: Any = None

    @property
    def trial_size(self) -> int:
        return int(self.world_size) // int(self.data_size)

    @property
    def trial_rank(self) -> int:
        return int(self.rank) // int(self.data_size)

    @property
    def data_rank(self) -> int:
        return int(self.rank) % int(self.data_size)

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis: size}``, the JAX ``Mesh.shape`` form: ``{"trials": W}``,
        or ``{"trials": T, "data": k}`` on a 2-D mesh."""
        if self.data_size > 1:
            return {self.axis: self.trial_size, DATA_AXIS: int(self.data_size)}
        return {self.axis: int(self.world_size)}

    def shard(self, chunk: int) -> Tuple[int, int]:
        """This rank's contiguous lanes ``[start, stop)`` of a chunk whose
        size is a multiple of the trial axis; the ranks of one data group
        get the same lanes."""
        n = self.trial_size
        if chunk % n:
            raise ValueError(f"chunk {chunk} is not a multiple of the trial axis {n}")
        local = chunk // n
        return self.trial_rank * local, (self.trial_rank + 1) * local

    def row_range(self, n: int) -> Tuple[int, int]:
        """This rank's contiguous rows ``[start, stop)`` of an ``n``-row
        table along the data axis: the shards cover the rows once and
        differ by at most one row (``data/streaming.host_block_set``'s
        rule)."""
        from ..data.streaming import host_block_set

        r = host_block_set(int(n), int(self.data_size), self.data_rank)
        return r.start, r.stop

    def row_shard(self, n: int) -> "RowShard":
        lo, hi = self.row_range(n)
        return RowShard(mesh=self, n=int(n), lo=lo, hi=hi)

    def trial_view(self) -> "TrialMesh":
        """The 1-D mesh of this rank's trial group: the lanes of a
        row-sharded bucket are sharded, reduced and gathered over it."""
        if self.data_size <= 1:
            return self
        return TrialMesh(group=self.trial_group, world_size=self.trial_size,
                         rank=self.trial_rank, device=self.device, axis=self.axis,
                         device_share=self.device_share)

    def flat(self) -> "TrialMesh":
        """The 1-D mesh of all ranks: the flat trial axis the buckets that
        are not row-sharded run on, with the whole table."""
        if self.data_size <= 1:
            return self
        return TrialMesh(group=self.group, world_size=self.world_size, rank=self.rank,
                         device=self.device, axis=self.axis, device_share=self.device_share)


@dataclasses.dataclass(frozen=True)
class RowShard:
    """A rank's rows of a row-sharded bucket: the 2-D mesh, the table's
    row count ``n`` and the rank's ``[lo, hi)``. The kernels route by
    ``n`` (so every rank takes the same path), reduce their row sums over
    ``mesh.data_group`` and score with global denominators."""

    mesh: TrialMesh
    n: int
    lo: int
    hi: int

    @property
    def key(self) -> tuple:
        """The stage-cache subkey of the rank's row-sharded forms."""
        return ("rows", int(self.mesh.data_size), self.mesh.data_rank)

    def ranges(self) -> list:
        """Every data rank's ``(lo, hi)``, in data-rank order."""
        from ..data.streaming import host_block_set

        k = int(self.mesh.data_size)
        return [(r.start, r.stop) for r in (host_block_set(self.n, k, j) for j in range(k))]


def local_device_count() -> int:
    """CUDA cards visible to this process (0 without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def trial_mesh(group=None, device=None, *, data_parallel: int = 1) -> TrialMesh:
    """This rank's mesh over ``group`` (default: the whole default group,
    after ``parallel.distributed.init_distributed``). ``device`` defaults
    to a card of this host, ``cuda:(rank % cards)``, and raises on a host
    with none; pass ``"cpu"`` to run the rank on the host.

    ``data_parallel=k`` > 1 builds a 2-D (trials, data) mesh of
    (W // k) x k ranks and raises ``ValueError`` when the world size W is
    not a multiple of k (as JAX does). Its sub-groups are made with
    ``dist.new_group``, itself a collective: every rank of the default
    group must make this call, in the same order. ``data_parallel=1`` is
    the 1-D mesh. Over more than one rank a collective: the ranks count who
    shares their device."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("trial_mesh needs an initialized process group "
                           "(parallel.distributed.init_distributed)")
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    k = int(data_parallel)
    if k < 1:
        raise ValueError(f"data_parallel={data_parallel} must be at least 1")
    if world % k:
        raise ValueError(f"{world} ranks not divisible by data_parallel={k}")
    if device is None:
        n = local_device_count()
        if n == 0:
            raise RuntimeError(
                "no CUDA card for this rank: pass device='cpu' to run the mesh on the host")
        dev = torch.device("cuda", rank % n)
    else:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", rank % max(local_device_count(), 1))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    share = 1
    if world > 1:
        # ranks sharing a card (or the host) each budget their share of its
        # memory: the trial engine's chunk caps and the stage cache
        from ..data import stage_cache

        keys = [None] * world
        dist.all_gather_object(keys, (socket.gethostname(), str(dev)), group=group)
        share = keys.count((socket.gethostname(), str(dev)))
        stage_cache.set_device_share(share)
    trial_group = data_group = None
    if k > 1:
        from .distributed import group_timeout

        ranks = (dist.get_process_group_ranks(group) if group is not None
                 else list(range(world)))
        timeout = group_timeout()
        # one fixed order on every rank: the data groups (one a trial
        # coordinate), then the trial groups (one a data coordinate)
        for t in range(world // k):
            g = dist.new_group([ranks[t * k + j] for j in range(k)], timeout=timeout)
            if t == rank // k:
                data_group = g
        for j in range(k):
            g = dist.new_group([ranks[t * k + j] for t in range(world // k)], timeout=timeout)
            if j == rank % k:
                trial_group = g
    return TrialMesh(group=group, world_size=int(world), rank=int(rank), device=dev,
                     device_share=share, data_size=k, trial_group=trial_group,
                     data_group=data_group)


def mesh_info(mesh) -> tuple:
    """``(n_devices, {axis: size})`` of a worker's mesh slice, the report
    placement prices batches by; ``(1, None)`` with no mesh. Shared by the
    in-process (``ClusterRuntime.add_executor``) and remote (agent
    ``/subscribe``) registration paths."""
    if mesh is None:
        return 1, None
    try:
        shape = {str(k): int(v) for k, v in mesh.shape.items()}
        n = 1
        for v in shape.values():
            n *= v
        return max(n, 1), shape
    except Exception:  # noqa: BLE001 — an exotic mesh object: one device
        return 1, None


def effective_mesh(mesh: Optional[TrialMesh]) -> Optional[TrialMesh]:
    """The mesh the engine shards over: None for no mesh or a mesh of one
    rank."""
    if mesh is None or int(mesh.world_size) <= 1:
        return None
    return mesh


def pad_to_multiple(n: int, multiple: int) -> int:
    if multiple <= 1:
        return n
    return ((n + multiple - 1) // multiple) * multiple
