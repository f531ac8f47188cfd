"""The trial mesh: a set of ranks, one process and one device each.

Port of the JAX package's ``parallel/mesh.py``. There a mesh is many
devices driven by one process (``jax.sharding.Mesh`` over a ``trials``
axis); here it is PyTorch's own idiom, a ``torch.distributed`` process
group whose every rank owns one device. The trial engine shards each trial
chunk over the ranks in contiguous slices (parallel/trial_map.py), and the
collectives (parallel/collectives.py, parallel/distributed.py) reduce and
gather over the group.

A mesh of world size 1 is treated as no mesh (the engine's single-device
path), as the JAX engine drops a one-device mesh.
"""

from __future__ import annotations

import dataclasses
import socket
from typing import Any, Dict, Optional, Tuple

import torch

#: the one mesh axis of a 1-D trial mesh
TRIAL_AXIS = "trials"


@dataclasses.dataclass(frozen=True)
class TrialMesh:
    """One rank's view of a 1-D trial mesh: its process group (None is the
    default group), the group's size, this rank, the rank's device, and how
    many of the group's ranks run on that device and so split its memory."""

    group: Any
    world_size: int
    rank: int
    device: torch.device
    axis: str = TRIAL_AXIS
    device_share: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis: size}``, the JAX ``Mesh.shape`` form."""
        return {self.axis: int(self.world_size)}

    def shard(self, chunk: int) -> Tuple[int, int]:
        """This rank's contiguous lanes ``[start, stop)`` of a chunk whose
        size is a multiple of the world size."""
        if chunk % self.world_size:
            raise ValueError(f"chunk {chunk} is not a multiple of the mesh size "
                             f"{self.world_size}")
        local = chunk // self.world_size
        return self.rank * local, (self.rank + 1) * local


def local_device_count() -> int:
    """CUDA cards visible to this process (0 without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def trial_mesh(group=None, device=None) -> TrialMesh:
    """This rank's mesh over ``group`` (default: the whole default group,
    after ``parallel.distributed.init_distributed``). ``device`` defaults
    to a card of this host, ``cuda:(rank % cards)``, and raises on a host
    with none; pass ``"cpu"`` to run the rank on the host. Over more than
    one rank a collective: the ranks count who shares their device."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("trial_mesh needs an initialized process group "
                           "(parallel.distributed.init_distributed)")
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
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
    return TrialMesh(group=group, world_size=int(world), rank=int(rank), device=dev,
                     device_share=share)


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
