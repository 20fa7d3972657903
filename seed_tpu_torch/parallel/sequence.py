"""Sequence (context) parallelism: ring attention over a mesh axis
(counterpart of seed_tpu/parallel/sequence.py).

The sequence dimension is sharded over an axis in contiguous blocks in rank
order. Each rank keeps its query block and rotates the key/value blocks one
hop per step (``comm.ppermute``, batched isend/irecv), merging the partial
softmax of every block with the flash recurrence (running max m,
normalizer l, accumulator o, all fp32). The gradient flows back through the
same ring (the inverse permutation), as ``jax.grad`` takes it through
seed_tpu's ``lax.ppermute``.

The attention is plain torch: seed_tpu computes it with einsums in XLA, not
with a kernel. Blocks wholly in the future are computed then masked, as
there.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.attention import NEG_INF
from ..utils.tree import tree_map
from . import comm
from .mesh import AXIS_NAMES, DATA_AXIS, axis_index, axis_size, use_mesh


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name, causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention over a sequence-sharded axis; every rank of the axis
    calls it with its shard.

    q [B, Nl, H, D], k/v [B, Nl, H_kv, D]: the local sequence block (global
    S = Nl * axis size). GQA: k/v stay at H_kv width through the ring. fp32
    scores and statistics; P rounded to v's type before P@V, accumulated in
    fp32 (mha numerics)."""
    size = comm.size_of(axis_name)
    idx = comm.index_of(axis_name)
    B, Nl, H, D = q.shape
    h_kv = k.shape[2]
    g = H // h_kv
    qg = q.reshape(B, Nl, h_kv, g, D).float()
    scale = D ** -0.5 if scale is None else scale
    dev = q.device

    rows = idx * Nl + torch.arange(Nl, device=dev)[:, None]
    cols_local = torch.arange(Nl, device=dev)[None, :]

    m = torch.full((B, H, Nl), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Nl), dtype=torch.float32, device=dev)
    o = torch.zeros((B, Nl, H, D), dtype=torch.float32, device=dev)
    perm = comm.ring(size)

    kb, vb = k, v
    for step in range(size):
        src = (idx - step) % size                     # origin rank of kb/vb
        scores = torch.einsum("bnkgd,bmkd->bkgnm", qg, kb.float()) * scale
        scores = scores.reshape(B, H, Nl, Nl)
        if causal:
            mask = (src * Nl + cols_local) <= rows    # [Nl, Nl] global causal
            scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        if causal:                                    # exact zero for masked
            p = torch.where(mask, p, torch.zeros_like(p))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pg = p.to(vb.dtype).reshape(B, h_kv, g, Nl, Nl)
        o = o * corr.transpose(1, 2)[..., None] + torch.einsum(
            "bkgnm,bmkd->bnkgd", pg.float(), vb.float()).reshape(B, Nl, H, D)
        m = m_new
        if step < size - 1:
            kb = comm.ppermute(kb, axis_name, perm)
            vb = comm.ppermute(vb, axis_name, perm)

    out = o / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def _block(x: torch.Tensor, axis, dim: int = 1) -> torch.Tensor:
    """This rank's contiguous block of a replicated ``x`` along ``dim``."""
    n = comm.size_of(axis)
    if x.shape[dim] % n:
        raise ValueError(f"seq len {x.shape[dim]} not divisible by sp={n}")
    return x.chunk(n, dim)[comm.index_of(axis)]


def sequence_parallel_attention(q, k, v, mesh, axis: str = DATA_AXIS,
                                causal: bool = True,
                                scale: Optional[float] = None):
    """Ring attention on GLOBAL [B, S, H, D] inputs, the same on every rank:
    each rank takes its sequence block of ``axis``, runs the ring, and the
    blocks are gathered back, so every rank returns the global output."""
    with use_mesh(mesh):
        q, k, v = (_block(comm.replicated_in(t, axis), axis) for t in (q, k, v))
        out = ring_attention(q, k, v, axis, causal=causal, scale=scale)
        return comm.replicated_out(
            comm.all_gather(out, axis, dim=1, tiled=True), axis)


def llama_loss_sp(params, input_ids: torch.Tensor, cfg, mesh,
                  axis: str = DATA_AXIS,
                  labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequence-parallel LLaMA next-token loss: activations sharded over the
    sequence dim of ``axis``, attention as a ring, everything else local.
    Equal to ``next_token_loss(forward(params, ids), ids, labels)`` on one
    device. ``params`` and ``input_ids`` are the global values on every
    rank; the gradient every rank gets for ``params`` is the whole one.

    The shifted-target boundary (the last local position's label is the
    first token of the right neighbour's block) is closed with one more
    ppermute; the last global position carries no loss."""
    from ..models import llama as M
    from ..train.losses import IGNORE_INDEX

    with use_mesh(mesh):
        size = axis_size(axis)
        B, S = input_ids.shape
        if S % size:
            raise ValueError(f"seq len {S} not divisible by sp={size}")
        labels = input_ids if labels is None else labels
        recv_right = [((j + 1) % size, j) for j in range(size)]
        idx = axis_index(axis)

        p = tree_map(lambda t: comm.replicated_in(t, AXIS_NAMES), params)
        ids, labs = _block(input_ids, axis), _block(labels, axis)
        Nl = ids.shape[1]
        positions = idx * Nl + torch.arange(Nl, device=ids.device)
        logits = M.forward(
            p, ids, cfg, positions=positions,
            attn_fn=lambda q, k, v: ring_attention(q, k, v, axis))
        # next-token targets: local shift + right neighbour's first label
        nxt = comm.ppermute(labs[:, :1].contiguous(), axis, recv_right)
        tgt = torch.cat([labs[:, 1:], nxt], dim=1)               # [B, Nl]
        valid = tgt != IGNORE_INDEX
        # the last GLOBAL position has no next token
        is_tail = (torch.arange(Nl, device=ids.device) == Nl - 1) & (idx == size - 1)
        valid = valid & ~is_tail[None, :]
        logp = torch.log_softmax(logits.float(), dim=-1)
        tok = torch.gather(logp, -1, torch.where(valid, tgt, 0)[..., None].long())[..., 0]
        loss_sum = comm.psum(-(tok * valid).sum(), axis)
        count = comm.psum(valid.sum().float(), axis)
        # every rank of the mesh holds the value (the other axes compute it
        # again)
        return comm.replicated_out(loss_sum / count.clamp_min(1), AXIS_NAMES)
