"""Rule-based parameter partitioning (counterpart of
seed_tpu/parallel/partition.py).

A parameter's tree path is matched against ordered ``(pattern,
PartitionSpec)`` rules; the first hit wins. Unmatched parameters get an
automatic FSDP spec: the largest dimension divisible by the fsdp axis size
(and at least twice it) is sharded. The specs equal seed_tpu's leaf for leaf,
so a layout (and a checkpoint saved from it) carries between the packages.
The port keeps a model's layers as a list of per-layer trees where seed_tpu
stacks them on a leading [L] axis; a rule written for the trailing dims
matches both, and seed_tpu's padding of leading ``None`` has no leading axis
to pad here.

``shard_params`` places a tree as DTensors on the mesh's axes of size > 1
(``mesh.compute_mesh``): every rank holds its shard of each leaf, and the
model code, which only builds and reads trees, runs on them unchanged.
"""
from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

import torch

from ..utils.tree import map_with_path, path_str, tree_map
from .local import full_tree, whole  # noqa: F401  (re-exported)
from .mesh import (FSDP_AXIS, TENSOR_AXIS, Sharding, compute_mesh,
                   mesh_shape)


class P:
    """PartitionSpec: one entry per leading dim of a leaf, each None (not
    sharded), an axis name, or a tuple of axis names (sharded over their
    product, the first outermost). Missing trailing entries are None. Not a
    tuple, so that a tree of specs has them as its leaves."""

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"P{self.entries!r}"


Rules = List[Tuple[str, P]]


def _auto_fsdp_spec(shape, mesh) -> P:
    """Shard the largest divisible dim over fsdp; replicate small params."""
    fsdp = mesh_shape(mesh)[FSDP_AXIS]
    if fsdp == 1 or not shape:
        return P()
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if shape[i] % fsdp == 0 and shape[i] >= 2 * fsdp:
            spec = [None] * len(shape)
            spec[i] = FSDP_AXIS
            return P(*spec)
    return P()


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def make_param_specs(params, mesh, rules: Optional[Rules] = None):
    """Tree of PartitionSpec matching ``params`` (tensors, meta tensors, or
    anything with a ``shape``; a leaf without one, such as an optimizer's
    step count, is replicated)."""
    compiled = [(re.compile(pat), spec) for pat, spec in (rules or [])]

    def spec_for(path, leaf):
        name = path_str(path)
        rank = len(_shape(leaf))
        for pat, spec in compiled:
            if pat.search(name):
                # rules are written for the trailing dims (2-D kernels)
                if 0 < len(spec) < rank:
                    return P(*([None] * (rank - len(spec)) + list(spec)))
                return spec
        return _auto_fsdp_spec(_shape(leaf), mesh)

    return map_with_path(spec_for, params)


def make_shardings(params, mesh, rules: Optional[Rules] = None):
    specs = make_param_specs(params, mesh, rules)
    return tree_map(lambda s: Sharding(mesh, s), specs)


def placements(mesh, spec: P):
    """DTensor placements of ``spec`` on ``compute_mesh(mesh)``."""
    from torch.distributed.tensor import Replicate, Shard
    cmesh = compute_mesh(mesh)
    out = []
    for axis in cmesh.mesh_dim_names:
        place = Replicate()
        for dim, entry in enumerate(spec):
            names = (entry,) if isinstance(entry, str) else (entry or ())
            if axis in names:
                place = Shard(dim)
        out.append(place)
    return out


def distribute(x: torch.Tensor, mesh, spec: P):
    """``x`` (the full value, the same on every rank) as a DTensor laid out
    by ``spec``; each rank keeps its shard only."""
    from torch.distributed.tensor import distribute_tensor
    if not isinstance(x, torch.Tensor):
        return x
    return distribute_tensor(x.detach(), compute_mesh(mesh),
                             placements(mesh, spec))


def shard_params(params, mesh, rules: Optional[Rules] = None):
    """A param tree as DTensors laid out by its computed specs."""
    specs = make_param_specs(params, mesh, rules)
    return tree_map(lambda x, s: distribute(x, mesh, s), params, specs)


# --- Tensor-parallel rules for the LLaMA decoder ------------------------
# Megatron-style: qkv/gate/up column-parallel (shard output dim over
# 'tensor'), o/down row-parallel (shard input dim). Embedding/lm_head shard
# the vocab dim.
LLAMA_TP_RULES: Rules = [
    (r"(q_proj|k_proj|v_proj|gate_proj|up_proj)/kernel$", P(FSDP_AXIS, TENSOR_AXIS)),
    (r"(o_proj|down_proj)/kernel$", P(TENSOR_AXIS, FSDP_AXIS)),
    (r"embed_tokens/embedding$", P(TENSOR_AXIS, FSDP_AXIS)),
    (r"lm_head/kernel$", P(FSDP_AXIS, TENSOR_AXIS)),
    (r"(input_layernorm|post_attention_layernorm|norm)/scale$", P()),
]

# ViT / Q-Former towers: FSDP-shard big matrices, replicate the rest.
VIT_TP_RULES: Rules = [
    (r"(fc1|qkv)/kernel$", P(FSDP_AXIS, TENSOR_AXIS)),
    (r"(fc2|proj)/kernel$", P(TENSOR_AXIS, FSDP_AXIS)),
]
