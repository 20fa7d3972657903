"""Pipeline parallelism: GPipe-style microbatch pipelining over the ``pipe``
mesh axis (counterpart of seed_tpu/parallel/pipeline.py).

The schedule is seed_tpu's: M + pp - 1 steps; at each step every stage runs
its resident layers on what it holds and hands the activations one hop down
the pipe (``comm.ppermute``); the last stage records microbatch t - (pp - 1).
Autograd runs the schedule backwards through the inverse permutations, as
``jax.grad`` does through seed_tpu's ``lax.scan``. Every stage runs every
step, bubbles included, and picks its input and records its output by
selects, as seed_tpu does: each rank then builds the same graph, so every
rank meets the backward's collectives in the same order.

The port keeps a model's layers as a list; a stage holds L/pp contiguous
layers of it. The losses take the global parameters and batch on every rank
and take the stage's layers and the rank's rows themselves.

Throughput note: with M microbatches the bubble fraction is
(pp-1)/(M+pp-1); choose M >= 4*pp for >80% pipeline efficiency.
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch

from ..utils.tree import tree_map
from . import comm
from .mesh import (AXIS_NAMES, BATCH_AXES, DATA_AXIS, FSDP_AXIS, PIPE_AXIS,
                   TENSOR_AXIS, axis_index, axis_size, batch_slice,
                   mesh_shape, use_mesh)


def pipeline_forward(layer_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     stage_params: List[Any], x_mb: torch.Tensor,
                     axis: str = PIPE_AXIS) -> torch.Tensor:
    """Run a layer sequence as a microbatch pipeline; every rank of ``axis``
    calls it.

    layer_fn(one_layer_params, h) -> h        (applies ONE layer)
    stage_params: this stage's layers (a list, L/pp of them)
    x_mb: [M, mb, ...] microbatches, the same on every stage (stage 0
        consumes them)

    Returns [M, mb, ...], the last stage's outputs, on every stage."""
    pp = comm.size_of(axis)
    stage = comm.index_of(axis)
    M = x_mb.shape[0]
    perm = comm.ring(pp)
    first = torch.tensor(stage == 0, device=x_mb.device)
    last = stage == pp - 1
    h_in = torch.zeros_like(x_mb[0])
    outs = [torch.zeros_like(x_mb[0]) for _ in range(M)]
    for t in range(M + pp - 1):
        # stage 0 ingests microbatch t (clipped: the bubble steps' results
        # are never recorded)
        h = torch.where(first, x_mb[min(t, M - 1)], h_in)
        for lp in stage_params:
            h = layer_fn(lp, h)
        # the last stage records microbatch t - (pp - 1) once it emerges
        if t >= pp - 1:
            rec = torch.tensor(last, device=x_mb.device)
            outs[t - (pp - 1)] = torch.where(rec, h, outs[t - (pp - 1)])
        h_in = comm.ppermute(h, axis, perm)
    # broadcast the last stage's outputs to every stage (an all-gather and a
    # take, whose gradient goes to the last stage only)
    return comm.all_gather(torch.stack(outs), axis)[pp - 1]


def num_stage_layers(total_layers: int, mesh) -> int:
    pp = mesh_shape(mesh)[PIPE_AXIS]
    if total_layers % pp != 0:
        raise ValueError(f"{total_layers} layers not divisible by pp={pp}")
    return total_layers // pp


def _stage_layers(layers: List[Any], mesh) -> List[Any]:
    n = num_stage_layers(len(layers), mesh)
    s = axis_index(PIPE_AXIS, mesh)
    return layers[s * n:(s + 1) * n]


def _pipeline_loss(params, ids: torch.Tensor, cfg, num_microbatches: int,
                   stage_layers: List[Any], layer_params: Callable,
                   batch_axes) -> torch.Tensor:
    """Embed, the pipelined stack, logits and the next-token loss of the
    rank's rows, averaged over ``batch_axes`` and replicated on every rank."""
    from ..models import layers as L
    from ..models import llama as M
    from ..ops.attention import sliced_causal_mask
    from ..train.losses import next_token_loss

    N = ids.shape[1]
    positions = torch.arange(N, device=ids.device)
    mask = sliced_causal_mask(N, N, 0, ids.device)
    rest = {k: tree_map(lambda t: comm.replicated_in(t, AXIS_NAMES), v)
            for k, v in params.items() if k != "layers"}

    def layer_fn(lp, h):
        return M.layer_apply(layer_params(lp), h, positions, mask, cfg)

    x = L.embed(rest["embed_tokens"], ids)
    mb = ids.shape[0] // num_microbatches
    x_mb = x.reshape(num_microbatches, mb, N, -1)
    h = pipeline_forward(layer_fn, stage_layers, x_mb).reshape(
        ids.shape[0], N, -1)
    loss = comm.pmean(next_token_loss(M._logits(rest, h, cfg), ids),
                      batch_axes)
    return comm.replicated_out(loss, AXIS_NAMES)


def pipeline_llama_loss(params, input_ids: torch.Tensor, cfg, mesh,
                        num_microbatches: int) -> torch.Tensor:
    """Next-token LM loss of the LLaMA, pipelined over ``pipe`` (layers
    split into stages) and data-parallel over ``data``.

    ``params`` and ``input_ids`` are the global values on every rank.
    Embedding and lm_head run replicated on every stage; a stage's layers
    are replicated over the other axes. Returns the mean loss, the same on
    every rank; the gradient a rank gets is the whole one for the embedding,
    the norm and the head, and the whole one of its stage's layers."""
    B, _ = input_ids.shape
    if B % num_microbatches != 0:
        raise ValueError(f"batch {B} not divisible by M={num_microbatches}")
    with use_mesh(mesh):
        others = (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS)
        stage = [tree_map(lambda t: comm.replicated_in(t, others), lp)
                 for lp in _stage_layers(params["layers"], mesh)]
        d = axis_size(DATA_AXIS)
        rows = input_ids.chunk(d, 0)[axis_index(DATA_AXIS)]
        return _pipeline_loss(params, rows, cfg, num_microbatches, stage,
                              lambda lp: lp, DATA_AXIS)


def _fsdp_gather_dim(per_layer_shape, fsdp: int) -> int:
    """Which per-layer dim the fsdp axis shards (``partition._auto_fsdp_spec``:
    the largest divisible dim); -1 = replicate."""
    order = sorted(range(len(per_layer_shape)),
                   key=lambda i: -per_layer_shape[i])
    for i in order:
        if per_layer_shape[i] % fsdp == 0 and per_layer_shape[i] >= 2 * fsdp:
            return i
    return -1


def pipeline_fsdp_llama_loss(params, input_ids: torch.Tensor, cfg, mesh,
                             num_microbatches: int) -> torch.Tensor:
    """:func:`pipeline_llama_loss` with the stage's layers also sharded over
    ``fsdp`` on their largest per-layer dim: a rank keeps 1/fsdp of each of
    its stage's layers and all-gathers a layer just before it runs (ZeRO-3),
    so the gradient is reduce-scattered back to the shards. The batch shards
    over (data, fsdp) jointly. The gradient a rank gets for a layer is the
    whole gradient of its shard (zero elsewhere in the leaf)."""
    B, _ = input_ids.shape
    with use_mesh(mesh):
        fsdp = axis_size(FSDP_AXIS)
        shards = axis_size(BATCH_AXES)
        if B % (shards * num_microbatches) != 0:
            raise ValueError(
                f"batch {B} not divisible by data*fsdp*M={shards}*"
                f"{num_microbatches}")
        me = axis_index(FSDP_AXIS)

        def shard(w, d):
            w = w if d < 0 else w.chunk(fsdp, d)[me]
            return comm.replicated_in(w, (DATA_AXIS, TENSOR_AXIS))

        # (shards, gather dims) per layer, the dims from the global shapes
        stage = []
        for lp in _stage_layers(params["layers"], mesh):
            dims = tree_map(lambda w: _fsdp_gather_dim(tuple(w.shape), fsdp),
                            lp)
            stage.append((tree_map(shard, lp, dims), dims))

        def gather(layer):
            return tree_map(lambda w, d: w if d < 0 else comm.all_gather(
                w, FSDP_AXIS, dim=d, tiled=True), *layer)

        rows = input_ids[batch_slice(mesh, B)]
        return _pipeline_loss(params, rows, cfg, num_microbatches, stage,
                              gather, BATCH_AXES)
