"""Device meshes and sharding layouts for multi-carrier/multi-slot scale-out.

Counterpart of ``srsran_project_23_5_tpu/parallel/mesh.py``.  Carriers and
slot batches are leading tensor dimensions split over a mesh of ranks, one
device per rank (``launch.spawn`` starts them).  The mesh is a
``torch.distributed.device_mesh.DeviceMesh``; a ``Sharding`` slices a
global tensor, which every rank holds, to this rank's rows (``local``,
the ``shard_map`` body's view) and gathers a per-rank result back into the
global tensor (``gather``).  The PHY runs on plain local tensors, never on
``DTensor``s: the LDPC wrappers take raw pointers.

The default process group must be initialised before a mesh is made, so
that its backend is the caller's choice.  Under gloo, CUDA tensors cross
ranks through host memory: gloo's point-to-point operations take CPU
tensors only.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils.device import resolve
from ..utils.tracing import tracer

CARRIER_AXIS = "carrier"
SLOT_AXIS = "slot"


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: initialise the default group "
                           "(parallel.launch) before making a mesh")
    return dist.get_world_size()


def _mesh(device, ranks: torch.Tensor, names: tuple[str, ...]) -> DeviceMesh:
    if not 1 <= ranks.numel() <= _world_size():
        raise ValueError(f"a mesh of {ranks.numel()} ranks in a world of "
                         f"{dist.get_world_size()}")
    dev = resolve(device)
    if dev.type == "cuda" and dev.index != torch.cuda.current_device():
        raise ValueError(f"the mesh's device {dev} is not this rank's "
                         f"current CUDA device {torch.cuda.current_device()}")
    return DeviceMesh(dev.type, ranks, mesh_dim_names=names)


def make_mesh(n_devices: int | None = None,
              device: torch.device | str | None = None) -> DeviceMesh:
    """1-D mesh over the first n_devices ranks (default: all) along the
    carrier axis, the natural RAN scale-out unit.  device: this rank's
    device (default: the current CUDA device)."""
    n = _world_size() if n_devices is None else n_devices
    return _mesh(device, torch.arange(n), (CARRIER_AXIS,))


def make_mesh_2d(n_slot: int, n_carrier: int,
                 device: torch.device | str | None = None) -> DeviceMesh:
    """2-D ("slot", "carrier") mesh: ranks 0 .. n_slot·n_carrier−1 laid out
    row-major, so rank r sits where JAX puts device r.  Carriers scale
    across one axis, the slot (time) batch across the other, whose shards
    exchange boundary-sample halos (``halo_from_prev``)."""
    ranks = torch.arange(n_slot * n_carrier).reshape(n_slot, n_carrier)
    return _mesh(device, ranks, (SLOT_AXIS, CARRIER_AXIS))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def host_staged(group, x: torch.Tensor) -> bool:
    """Whether `x` crosses ranks through host memory: CUDA tensors under
    gloo."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


@dataclasses.dataclass(frozen=True)
class Sharding:
    """The leading dimension of a global tensor split over `axis` of
    `mesh` (replicated over the other axes), or replicated everywhere when
    axis is None."""
    mesh: DeviceMesh
    axis: str | None

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the global `x` (which every rank holds), on
        this rank's device.  Raises when the axis does not divide the
        leading dimension."""
        dev = mesh_device(self.mesh)
        if self.axis is None:
            return x.to(dev)
        n = _axis_size(self.mesh, self.axis)
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not split over the "
                             f"{n} shards of the {self.axis} axis")
        rows = x.shape[0] // n
        i = self.mesh.get_local_rank(self.axis)
        return x[i * rows:(i + 1) * rows].to(dev)

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """The global tensor from each rank's `y` (the rows ``local``
        gave it), on this rank's device.  Adds the bytes this rank sends to
        the tracer's count ``mesh.gather_bytes``."""
        if self.axis is None:
            return y
        group = self.mesh.get_group(self.axis)
        send = y.contiguous()
        tracer.add("mesh.gather_bytes", send.numel() * send.element_size())
        if host_staged(group, y):
            send = send.cpu()
        parts = [torch.empty_like(send)
                 for _ in range(_axis_size(self.mesh, self.axis))]
        dist.all_gather(parts, send, group=group)
        return torch.cat(parts).to(y.device)


def carrier_sharding(mesh: DeviceMesh) -> Sharding:
    """Shard the leading (carrier) dim, replicate the rest."""
    return Sharding(mesh, CARRIER_AXIS)


def slot_sharding(mesh: DeviceMesh) -> Sharding:
    """Shard the leading (slot-batch) dim."""
    return Sharding(mesh, SLOT_AXIS)


def replicated(mesh: DeviceMesh) -> Sharding:
    return Sharding(mesh, None)


def halo_from_prev(x: torch.Tensor, halo: int, mesh: DeviceMesh,
                   axis: str) -> torch.Tensor:
    """Ring halo exchange along a sharded slot/time axis: prepend the
    PREVIOUS shard's trailing `halo` samples (last axis of `x`) to this
    shard's.  The first shard receives the last shard's tail (callers
    treat the stream as circular or mask shard 0); on an axis of one shard
    that is its own tail.

    The RAN use case is a PRACH window that starts near the end of slot
    shard i−1 and completes in shard i (the reference reads a contiguous
    host ring buffer instead).  One send and one receive per rank on the
    axis's group; under gloo a CUDA tail is staged through host memory.
    """
    if not 1 <= halo <= x.shape[-1]:
        raise ValueError(f"halo {halo} outside 1..{x.shape[-1]} samples")
    tail = x[..., -halo:].contiguous()
    group = mesh.get_group(axis)
    n, me = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return torch.cat([tail, x], dim=-1)
    send = tail.cpu() if host_staged(group, tail) else tail
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send,
                      dist.get_global_rank(group, (me + 1) % n), group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(group, (me - 1) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return torch.cat([recv.to(x.device), x], dim=-1)
