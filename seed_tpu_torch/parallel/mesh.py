"""The device mesh and the batch layout (counterpart of
seed_tpu/parallel/mesh.py).

seed_tpu lays its devices out as one ``jax.sharding.Mesh`` with the named
axes (data, fsdp, pipe, tensor); the port builds the same mesh as a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, one rank per card (NCCL on ``cuda:{LOCAL_RANK}``) or, when the
caller asks for ``device_type="cpu"``, one process per rank over gloo.

- ``data``   — pure data parallelism (the batch split; gradients summed)
- ``fsdp``   — ZeRO-3 style sharding of parameters and optimizer moments
- ``pipe``   — pipeline stages (parallel/pipeline.py)
- ``tensor`` — tensor parallelism (attention heads, MLP hidden, vocabulary)

The batch is split over (data, fsdp) jointly, data-major, as seed_tpu's
``P((data, fsdp))``. A program runs the same code on every rank (SPMD); a
batch handed to it is the rank's slice of the host batch (``shard_batch``),
so a batch size stays global, as seed_tpu's does.

Spec computations (parallel/partition.py) also accept a plain mapping
``{axis: size}`` in place of a mesh, so layouts can be computed with no
process group.
"""
from __future__ import annotations

import math
import os
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..utils.tree import tree_map

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
PIPE_AXIS = "pipe"
TENSOR_AXIS = "tensor"
AXIS_NAMES = (DATA_AXIS, FSDP_AXIS, PIPE_AXIS, TENSOR_AXIS)
BATCH_AXES = (DATA_AXIS, FSDP_AXIS)

_CURRENT: list = []     # the mesh axis names resolve against (use_mesh)


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs an initialised process group: call "
            "torch.distributed.init_process_group first (torchrun sets its "
            "environment), with backend 'nccl' for cuda or 'gloo' for cpu")
    return dist.get_world_size()


def make_mesh(dp: int = 1, fsdp: int = -1, tp: int = 1, pp: int = 1,
              device_type: str = "cuda"):
    """A (data, fsdp, pipe, tensor) DeviceMesh over every rank of the default
    process group, tensor innermost. ``fsdp=-1`` absorbs the ranks the other
    axes leave. A one-rank mesh is valid: every layout on it is replicated.

    ``device_type`` is "cuda" (one card per rank, ``cuda:{LOCAL_RANK}``) unless
    the caller asks for "cpu"; nothing picks gloo by itself. The mesh becomes
    the one axis names resolve against (``current_mesh``)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = _world()
    if fsdp == -1:
        fsdp = n // (dp * tp * pp)
    if dp * fsdp * tp * pp != n:
        raise ValueError(f"mesh {dp}x{fsdp}x{pp}x{tp} != {n} devices")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(device_type='cuda') but CUDA is not "
                               "available; pass device_type='cpu' for gloo")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    mesh = init_device_mesh(device_type, (dp, fsdp, pp, tp),
                            mesh_dim_names=AXIS_NAMES)
    _CURRENT[:] = [mesh]
    return mesh


def auto_mesh(n: Optional[int] = None, tp: int = 1,
              device_type: str = "cuda"):
    """Default mesh: tensor-parallel innermost, fsdp over the rest. ``n``, if
    given, must be the number of ranks (every rank takes part)."""
    world = _world()
    n = world if n is None else n
    if n != world:
        raise ValueError(f"auto_mesh(n={n}) on {world} ranks: the port's mesh "
                         "spans every rank of the process group")
    if n % tp != 0:
        raise ValueError(f"{n} devices not divisible by tp={tp}")
    return make_mesh(dp=1, fsdp=n // tp, tp=tp, device_type=device_type)


def current_mesh():
    """The mesh axis names resolve against: the innermost ``use_mesh``, else
    the last one ``make_mesh`` built; None when there is none."""
    return _CURRENT[-1] if _CURRENT else None


def _resolve(mesh):
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise RuntimeError("an axis name needs a mesh: build one with "
                           "make_mesh or enter use_mesh(mesh)")
    return mesh


@contextmanager
def use_mesh(mesh):
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis: size} of a DeviceMesh, or of a mapping given in its place."""
    if isinstance(mesh, Mapping):
        return {a: int(mesh.get(a, 1)) for a in AXIS_NAMES}
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def local_mesh_size(mesh) -> int:
    return math.prod(mesh_shape(mesh).values())


# ------------------------------ sub-groups -----------------------------------

Axes = Union[str, Sequence[str]]


def _axes(axis: Axes) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_size(axis: Axes, mesh=None) -> int:
    shape = mesh_shape(_resolve(mesh))
    return math.prod(shape[a] for a in _axes(axis))


def axis_index(axis: Axes, mesh=None) -> int:
    """This rank's index along ``axis`` (several axes: row-major over them,
    the first outermost, as seed_tpu's joint ``(data, fsdp)``)."""
    mesh = _resolve(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    shape = mesh_shape(mesh)
    idx = 0
    for a in _axes(axis):
        idx = idx * shape[a] + coord[a]
    return idx


def axis_group(axis: Axes, mesh=None):
    """The process group of the ranks that share every coordinate but
    ``axis``. Several axes get one group over their product; it is made at
    the first call, which every rank makes (new_group is collective)."""
    mesh = _resolve(mesh)
    axes = _axes(axis)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    cache = mesh.__dict__.setdefault("_seed_groups", {})
    if axes not in cache:
        names = list(mesh.mesh_dim_names)
        order = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in order]
        grid = mesh.mesh.permute(*rest, *order).reshape(
            -1, math.prod(mesh.mesh.shape[i] for i in order))
        me = dist.get_rank()
        for ranks in grid.tolist():
            g = dist.new_group(ranks)
            if me in ranks:
                cache[axes] = g
    return cache[axes]




def compute_mesh(mesh):
    """The mesh's axes of size > 1 as a DeviceMesh (the ``tensor`` axis when
    all have size 1): DTensor layouts are placed on it, since a placement on
    an axis of size 1 changes nothing but costs its sharding propagation a
    factor per axis."""
    cache = mesh.__dict__.setdefault("_seed_compute", [])
    if not cache:
        shape = mesh_shape(mesh)
        names = tuple(a for a in AXIS_NAMES if shape[a] > 1) or (TENSOR_AXIS,)
        cache.append(mesh[names])
    return cache[0]


# ------------------------------ batch layout ---------------------------------

@dataclass(frozen=True)
class Sharding:
    """A mesh and a PartitionSpec (parallel/partition.py): the port's
    counterpart of ``NamedSharding``."""
    mesh: Any
    spec: Any


def batch_sharding(mesh) -> Sharding:
    """Input batches shard over data+fsdp jointly (standard FSDP batch
    layout)."""
    from .partition import P
    return Sharding(mesh, P(BATCH_AXES))


def replicated(mesh) -> Sharding:
    from .partition import P
    return Sharding(mesh, P())


def batch_slice(mesh, n: int, dim: int = 0) -> slice:
    """This rank's rows of a batch of ``n`` along ``dim`` under
    ``batch_sharding``."""
    size = axis_size(BATCH_AXES, mesh)
    if n % size:
        raise ValueError(f"batch of {n} not divisible by data*fsdp={size}")
    per = n // size
    i = axis_index(BATCH_AXES, mesh)
    return slice(i * per, (i + 1) * per)


def shard_batch(mesh, batch, dim: int = 0):
    """This rank's slice of a host batch (a tree of arrays or tensors) over
    (data, fsdp) along ``dim`` (1 for a [grad_accum, micro, ...] batch)."""
    def take(x):
        x = torch.as_tensor(x)
        s = batch_slice(mesh, x.shape[dim], dim)
        return x.narrow(dim, s.start, s.stop - s.start)
    return tree_map(take, batch)
