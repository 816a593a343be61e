"""The mesh axis and its three collectives on ``torch.distributed``.

The port runs multi-device work SPMD: every rank builds the same model
from the same seed, calls the same entry point, and keeps what the JAX
package leaves replicated replicated. A mesh is a
``torch.distributed.device_mesh.DeviceMesh``, the counterpart of
``jax.sharding.Mesh``; one of its axes is resolved to :class:`Axis`, the
process group of that axis with this rank's place in it, which carries
the three collectives the parallel code needs:

* :meth:`Axis.psum`, ``all_reduce`` SUM (JAX's ``lax.psum``);
* :meth:`Axis.broadcast` from the rank that owns a block;
* :meth:`Axis.gather_rows`, the rows of every rank stacked in rank order
  (JAX's tiled ``lax.all_gather``). Under NCCL it is
  ``all_gather_into_tensor``. Under gloo it is an ``all_reduce`` of a
  zero buffer with this rank's rows in place: JAX's one-hot ``psum`` form,
  and the one form gloo runs on CUDA tensors (gloo has ``broadcast``,
  ``all_reduce`` and ``barrier`` for them, no ``all_gather``).

No collective moves a tensor to the host.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

EXPERT_AXIS = "experts"


class Axis(NamedTuple):
    """One mesh axis as this rank sees it: the axis ``name``, its process
    ``group``, the number of ranks ``ndev`` on it and this rank's index
    ``me`` (``mesh.get_local_rank(axis)``)."""

    name: str
    group: object
    ndev: int
    me: int

    def _nccl(self, t) -> bool:
        return t.is_cuda and "nccl" in str(dist.get_backend(self.group))

    def psum(self, t):
        """Sum of ``t`` over the axis, in place; returns ``t``."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def broadcast(self, t, owner: int):
        """``t`` of the rank at index ``owner`` of the axis, in place on
        every rank; returns ``t``."""
        dist.broadcast(t, src=dist.get_global_rank(self.group, owner),
                       group=self.group)
        return t

    def gather_rows(self, t):
        """``[ndev * r, ...]``: the ``[r, ...]`` rows of every rank of the
        axis in rank order (every rank gives the same ``r``)."""
        r = t.shape[0]
        shape = (self.ndev * r,) + tuple(t.shape[1:])
        if self._nccl(t):
            out = t.new_empty(shape)
            dist.all_gather_into_tensor(out, t.contiguous(), group=self.group)
            return out
        out = t.new_zeros(shape)
        out[self.me * r:(self.me + 1) * r] = t
        return self.psum(out)


def resolve(mesh, axis: Optional[str] = EXPERT_AXIS,
            what: str = "this call shards") -> Axis:
    """The :class:`Axis` of ``mesh`` named ``axis``. ``axis=None`` takes
    the only axis of a 1-D mesh and raises on a mesh of more axes, whose
    other axes would stay unused (``what`` names the call in the
    message)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"mesh must be a torch.distributed.device_mesh.DeviceMesh "
            f"(parallel.make_mesh), got {type(mesh).__name__}")
    names = mesh.mesh_dim_names
    if axis is None:
        if mesh.ndim > 1:
            raise ValueError(
                f"{what} over a single mesh axis; this mesh has axes "
                f"{names} — pass axis='name' (the other axes stay UNUSED) "
                "or reshape the mesh to one axis")
        axis = names[0] if names else 0
    dim = names.index(axis) if isinstance(axis, str) else axis
    return Axis(axis, mesh.get_group(axis), mesh.shape[dim],
                mesh.get_local_rank(axis))


def make_mesh(n_devices: Optional[int] = None, axis: str = EXPERT_AXIS):
    """1-D ``DeviceMesh`` over the expert (leaf) axis, on the initialized
    default process group: every rank calls it. ``n_devices``, if given,
    must equal the world size (the JAX package takes the first
    ``n_devices`` devices of its one process; here each device is a rank
    of its own). The mesh's device type is ``'cuda'`` under NCCL and
    ``'cpu'`` otherwise (gloo ranks may still hold CUDA tensors)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs the default process group: call "
            "torch.distributed.init_process_group on every rank first "
            "(torchrun, or spawn with an init_method)")
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(
            f"make_mesh({n_devices}) on a world of {world} ranks: the mesh "
            f"spans the world, so start {n_devices} ranks instead")
    device_type = "cuda" if "nccl" in str(dist.get_backend()) else "cpu"
    return DeviceMesh(device_type, torch.arange(world),
                      mesh_dim_names=(axis,))
