"""Where the port's model, op and training code meets a sharded tree.

``shard_params`` lays a tree out as DTensors, and the model code runs on it
unchanged: DTensor carries most ops over a mesh by itself. The few places
where it does not, or where it would undo the sharding, call the functions
of this module and nothing else of DTensor. Each is the identity (or the
plain call) on a plain tensor, so the code runs as before without a mesh:

- ``product_operands`` / ``embedding``: a weight and its input as a
  product or a lookup consumes them (``layers.linear``, ``layers.embed``);
- ``on_local_shards``: attention on each rank's own rows and heads
  (``flash_attention``, and the KV cache of ``llama.prefill``);
- ``local_count``: how many heads of a projection a rank holds (the KV
  cache a sharded engine allocates);
- ``bincount``: counts over a sharded batch (the codebook usage of
  ``tokenizer_training.stage2_loss``);
- ``whole`` / ``full_tree``: a value gathered to every rank (a loss, a
  norm, the logits a sampler reads, a checkpoint).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..utils.tree import tree_map
from .mesh import TENSOR_AXIS


def is_sharded(x) -> bool:
    """True for a DTensor (a leaf of a sharded tree, or a value computed
    from one)."""
    return hasattr(x, "device_mesh")


def whole(x):
    """A DTensor's full value (a collective: every rank calls it); anything
    else as it is."""
    return x.full_tensor() if is_sharded(x) else x


def full_tree(tree):
    """Every DTensor of ``tree`` gathered to its full value."""
    return tree_map(whole, tree)


def gathered(w: torch.Tensor) -> torch.Tensor:
    """A weight as a product consumes it. A DTensor weight is all-gathered
    over every mesh axis but ``tensor`` just before its use (ZeRO-3: its
    gradient is reduce-scattered back to the shards), so the product runs
    tensor-parallel and its output keeps its heads sharded over ``tensor``."""
    if not is_sharded(w):
        return w
    from torch.distributed.tensor import Replicate
    place = [p if name == TENSOR_AXIS else Replicate()
             for name, p in zip(w.device_mesh.mesh_dim_names, w.placements)]
    return w if list(w.placements) == place else w.redistribute(
        w.device_mesh, place)


def product_operands(x: torch.Tensor, w: torch.Tensor):
    """``x`` and ``w`` [in, out] laid out for ``x @ w``; both as they are
    when ``w`` is plain. For a DTensor ``w``: ``gathered(w)``, and ``x``
    laid out so that the product runs Megatron-style and only activations
    move: over ``tensor``, ``x`` is whole for a column-parallel ``w`` (its
    output dim split: the product's output is split the same way) and split
    on its last dim for a row-parallel one (its input dim split: the product
    is a partial sum); over the other axes, rows of the batch stay split and
    every other layout is gathered. Left to itself, DTensor may instead
    gather the weight over ``tensor`` to meet a partial-sum ``x``."""
    if not is_sharded(w):
        return x, w
    from torch.distributed.tensor import DTensor, Replicate, Shard
    w = gathered(w)
    mesh = w.device_mesh
    if not is_sharded(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    place = []
    for name, px, pw in zip(mesh.mesh_dim_names, x.placements, w.placements):
        if name == TENSOR_AXIS:
            place.append(Shard(x.ndim - 1) if pw.is_shard(0) else Replicate())
        else:
            place.append(px if px.is_shard(0) else Replicate())
    if list(x.placements) != place:
        x = x.redistribute(mesh, place)
    return x, w


def embedding(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``. A DTensor table is gathered but over ``tensor``
    (``gathered``), so a batch of ids whose rows are split keeps them split;
    over ``tensor`` each rank looks up its share of the vocabulary and the
    lookups are summed (Megatron's vocab-parallel embedding)."""
    if not is_sharded(table):
        return table[ids]
    from torch.distributed.tensor import DTensor, Replicate
    table = gathered(table)
    if not is_sharded(ids):
        ids = DTensor.from_local(ids, table.device_mesh,
                                 [Replicate()] * table.device_mesh.ndim,
                                 run_check=False)
    out = torch.nn.functional.embedding(ids, table)
    place = [Replicate() if name == TENSOR_AXIS else p
             for name, p in zip(out.device_mesh.mesh_dim_names, out.placements)]
    return out if list(out.placements) == place else out.redistribute(
        out.device_mesh, place)


def local_count(n: int, w: torch.Tensor, dim: int = -1) -> int:
    """How many of the ``n`` units (heads) along ``w``'s dim ``dim`` a rank
    computes with the product ``gathered(w)`` gives: ``n`` over the sizes
    of the ``tensor`` axis that splits that dim, ``n`` for a plain ``w``."""
    if not is_sharded(w):
        return n
    dim = dim % w.ndim
    for name, p in zip(w.device_mesh.mesh_dim_names, w.placements):
        if name == TENSOR_AXIS and p.is_shard(dim):
            n //= w.device_mesh.size(w.device_mesh.mesh_dim_names.index(name))
    return n


def on_local_shards(fn: Callable, q, k, v, split_rows: bool = True, **kw):
    """``fn(q, k, v, **kw)`` on each rank's own shards of [B, S, H, D]
    DTensors q, k, v; plain tensors go to ``fn`` as they are. Heads stay
    sharded as they are; so do rows of the batch, and a partial sum is
    reduced onto them, unless ``split_rows`` is off (a KV cache that holds
    every row): then partial sums are reduced and rows gathered. A sharded
    sequence or head_dim is gathered (only activations move, never a
    weight). ``fn`` sees the local rows and heads, and returns [B, S, H, D]
    of them; the result is a DTensor of that layout."""
    if not is_sharded(q):
        return fn(q, k, v, **kw)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    keep = (0, 2) if split_rows else (2,)

    def local_layout(p):
        if isinstance(p, Shard):
            return p if p.dim in keep else Replicate()
        return Shard(0) if p.is_partial() and split_rows else Replicate()

    place = tuple(local_layout(p) for p in q.placements)
    q, k, v = (t if t.placements == place else t.redistribute(q.device_mesh, place)
               for t in (q, k, v))
    out = fn(q.to_local(), k.to_local(), v.to_local(), **kw)
    return DTensor.from_local(out, q.device_mesh, place, run_check=False)


def bincount(indices: torch.Tensor, n: int) -> torch.Tensor:
    """How often each of ``n`` ids occurs in ``indices``. A DTensor (ids of
    a batch sharded over a mesh) is counted on each rank's own rows and the
    counts summed: DTensor has no bincount, and the ids need not move."""
    if not is_sharded(indices):
        return torch.bincount(indices.reshape(-1).long(), minlength=n)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    local = torch.bincount(indices.to_local().reshape(-1).long(), minlength=n)
    place = [Partial() if p.is_shard() else Replicate()
             for p in indices.placements]
    return DTensor.from_local(local, indices.device_mesh, place).full_tensor()


__all__ = ["is_sharded", "whole", "full_tree", "gathered",
           "product_operands", "embedding", "local_count",
           "on_local_shards", "bincount"]
