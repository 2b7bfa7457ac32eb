"""Device mesh and the collectives of the sharded functions.

Counterpart of ``commpy_tpu/parallel/mesh.py``.  The mesh is PyTorch's
own: a 1-D :class:`~torch.distributed.device_mesh.DeviceMesh` over every
rank of the default process group, its one dimension named as the JAX
axis (``"dp"`` for frames, ``"sp"`` for time).  One process drives one
device, so a sharded function is SPMD: every rank calls it with its local
shard, as under ``torchrun``, and the collectives below meet across the
ranks.  Each names its JAX counterpart.

:func:`shard_map` and :class:`NamedSharding` are the global view the JAX
package's callers use: from a tensor every rank holds whole, the local
shard; from local results, the whole again (a tiled all-gather).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils.device import resolve_device
from . import distributed

Mesh = DeviceMesh

__all__ = ["make_mesh", "shard_map", "P", "Mesh", "NamedSharding",
           "local_device_count", "psum", "all_gather", "ppermute",
           "axis_index", "axis_size", "check_axis"]


def local_device_count() -> int:
    """The GPUs this process sees."""
    return torch.cuda.device_count()


def make_mesh(n_devices: int | None = None, axis_name: str = "dp",
              device="cuda") -> DeviceMesh:
    """1-D mesh over every rank, its dimension named ``axis_name``.

    Initialises the default process group when there is none
    (:func:`distributed.initialize`: torchrun's environment, else a world
    of one through a ``file://`` store).  ``device='cuda'`` meets over
    NCCL and raises without a GPU; ``'cpu'`` over gloo.  ``n_devices``,
    if given, must equal the world size: a rank is a device.
    """
    dev = resolve_device(device)
    distributed.initialize(device=dev.type)
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(
            f"a mesh of {n_devices} devices needs as many ranks; this "
            f"process group has {world} (start one process per device)")
    return DeviceMesh(dev.type, list(range(world)),
                      mesh_dim_names=(axis_name,))


def check_axis(mesh: DeviceMesh, axis_name: str) -> None:
    """Raise unless the mesh's one dimension is ``axis_name``, the axis a
    sharded function is told to split over (a JAX mesh axis by name)."""
    if mesh.mesh_dim_names != (axis_name,):
        raise ValueError(f"the mesh's dimension is {mesh.mesh_dim_names}, "
                         f"not ({axis_name!r},)")


def axis_size(mesh: DeviceMesh) -> int:
    """``jax.lax.axis_size``: the ranks along the mesh's dimension."""
    return mesh.size()


def axis_index(mesh: DeviceMesh) -> int:
    """``jax.lax.axis_index``: this rank's place along the dimension."""
    return mesh.get_local_rank()


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` in a dtype both backends carry (complex as real pairs, bool as
    bytes), contiguous."""
    if x.is_complex():
        x = torch.view_as_real(x)
    elif x.dtype == torch.bool:
        x = x.to(torch.uint8)
    return x.contiguous()


def _unwire(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.is_complex():
        return torch.view_as_complex(y)
    return y.to(torch.bool) if like.dtype == torch.bool else y


def psum(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """``jax.lax.psum``: the sum of ``x`` over the ranks, on every rank
    (``all_reduce`` SUM on a copy; bool sums as a logical or)."""
    y = _wire(x).clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.get_group())
    if x.dtype == torch.bool:
        return y > 0
    return _unwire(y, x)


def all_gather(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """``jax.lax.all_gather(..., tiled=True)``: the ranks' ``x`` one after
    another along dimension 0 (``all_gather_into_tensor``)."""
    D = axis_size(mesh)
    w = _wire(x)
    out = torch.empty((D * w.shape[0],) + tuple(w.shape[1:]), dtype=w.dtype,
                      device=w.device)
    dist.all_gather_into_tensor(out, w, group=mesh.get_group())
    return _unwire(out, x)


def ppermute(x: torch.Tensor, mesh: DeviceMesh, shift: int) -> torch.Tensor:
    """``jax.lax.ppermute`` with the ring permutation
    ``[(i, (i + shift) % D)]``: rank r gets the ``x`` of rank
    ``r - shift`` (mod D).

    One send and one receive a rank (``batch_isend_irecv``); when the
    peer is this rank (a shift of a multiple of D, so always at world
    size 1) it is a plain copy.  The sum and the gather go through the
    backend at every world size, one rank included.
    """
    D = axis_size(mesh)
    shift %= D
    if shift == 0:
        return x.clone()
    group = mesh.get_group()
    r = axis_index(mesh)
    w = _wire(x)
    out = torch.empty_like(w)
    ops = [dist.P2POp(dist.isend, w,
                      dist.get_global_rank(group, (r + shift) % D), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (r - shift) % D), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _unwire(out, x)


class P(tuple):
    """``jax.sharding.PartitionSpec``: per tensor dimension, the mesh
    dimension it is split over, or None."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


@dataclass(frozen=True)
class NamedSharding:
    """``jax.sharding.NamedSharding``: how a whole tensor splits over
    ``mesh`` by ``spec``.  At most one dimension is split."""

    mesh: DeviceMesh
    spec: P

    def _dim(self):
        name = self.mesh.mesh_dim_names[0]
        dims = [d for d, a in enumerate(self.spec) if a is not None]
        if len(dims) > 1 or any(self.spec[d] != name for d in dims):
            raise ValueError(f"spec {tuple(self.spec)} must split at most "
                             f"one dimension, over {name!r}")
        return dims[0] if dims else None

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the whole tensor ``x``."""
        d = self._dim()
        if d is None:
            return x
        D = axis_size(self.mesh)
        if x.shape[d] % D:
            raise ValueError(f"dimension {d} of size {x.shape[d]} does not "
                             f"split over {D} ranks")
        n = x.shape[d] // D
        return x.narrow(d, axis_index(self.mesh) * n, n)

    def gather(self, x_local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's shard ``x_local``."""
        d = self._dim()
        if d is None:
            return x_local
        return all_gather(x_local.movedim(d, 0), self.mesh).movedim(0, d)


def shard_map(f, mesh: DeviceMesh, in_specs, out_specs):
    """``jax.shard_map`` for tensors every rank holds whole: ``f`` runs on
    each rank's shards (by ``in_specs``) and its outputs are gathered whole
    (by ``out_specs``; ``P()`` outputs are returned as they are).  A
    single spec stands for a single argument or output."""
    single_in = isinstance(in_specs, P)
    single_out = isinstance(out_specs, P)

    def run(*args):
        specs = (in_specs,) if single_in else in_specs
        if len(specs) != len(args):
            raise ValueError(f"{len(args)} arguments for {len(specs)} specs")
        out = f(*(NamedSharding(mesh, s).shard(a)
                  for s, a in zip(specs, args)))
        outs = (out,) if single_out else out
        osp = (out_specs,) if single_out else out_specs
        res = tuple(NamedSharding(mesh, s).gather(o)
                    for s, o in zip(osp, outs))
        return res[0] if single_out else res

    return run
