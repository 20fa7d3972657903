"""Attention ops (counterpart of seed_tpu/ops/attention.py).

``mha`` is the plain path: fp32 scores and softmax, probabilities rounded to
the io type before P@V, mask value -1e9. It serves the Q-Former, the LLaMA
forward and every attention the short-sequence kernel does not take.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9  # large-negative in fp32; avoids bf16 overflow vs -10000 hack


def mha(
    q: torch.Tensor,           # [B, N, H, D]
    k: torch.Tensor,           # [B, M, H_kv, D]
    v: torch.Tensor,           # [B, M, H_kv, D]
    mask: Optional[torch.Tensor] = None,   # broadcastable to [B, H, N, M]; True = attend
    bias: Optional[torch.Tensor] = None,   # additive bias, same broadcast
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Multi-head attention with fp32 softmax. Supports GQA (H_kv divides H)."""
    B, N, H, D = q.shape
    h_kv = k.shape[2]
    if h_kv != H:  # grouped-query: repeat kv heads
        rep = H // h_kv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = scale if scale is not None else D ** -0.5

    # bf16 products are exact in fp32, so upcasting first is the fp32
    # accumulation of seed_tpu's preferred_element_type=float32
    scores = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias.float()
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", probs, v.to(q.dtype))


def causal_mask(n: int, m: Optional[int] = None, device=None) -> torch.Tensor:
    """[1, 1, n, m] lower-triangular mask (True = attend)."""
    m = m if m is not None else n
    row = torch.arange(n, device=device)[:, None]
    col = torch.arange(m, device=device)[None, :]
    return (col <= row + (m - n))[None, None]


def decode_mask(kv_len: int, cache_index: int, device=None) -> torch.Tensor:
    """[1, 1, 1, kv_len] mask for single-token decode over a KV cache:
    positions <= cache_index are valid."""
    col = torch.arange(kv_len, device=device)[None, :]
    return (col <= cache_index)[None, None]


def sliced_causal_mask(q_len: int, kv_len: int, q_offset: int,
                       device=None) -> torch.Tensor:
    """Causal mask for a query chunk starting at ``q_offset`` within a longer
    preallocated KV buffer (chunked prefill, decode)."""
    row = torch.arange(q_len, device=device)[:, None]
    col = torch.arange(kv_len, device=device)[None, :]
    return (col <= row + q_offset)[None, None]
