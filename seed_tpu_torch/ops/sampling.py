"""Token sampling: temperature / top-k / top-p (nucleus) / greedy
(counterpart of seed_tpu/ops/sampling.py).

Draws come from an explicit torch.Generator. They cannot reproduce
seed_tpu's jax.random streams; the filters (apply_top_k / apply_top_p) and
greedy decoding are what match exactly.
"""
from __future__ import annotations

import torch

NEG_INF = -1e9


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0:
        return logits
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < thresh, NEG_INF)


def apply_top_p(logits: torch.Tensor, p: float,
                candidates: int = 0) -> torch.Tensor:
    """Nucleus filtering, HF semantics: keep the smallest set of tokens with
    cumulative probability > p (the first token crossing p is kept).

    ``candidates`` > 0 looks for the nucleus among the top ``candidates``
    tokens only (probabilities still normalized over the full vocabulary)."""
    if candidates and candidates < logits.shape[-1]:
        vals = torch.topk(logits, candidates, dim=-1).values   # descending
        lse = torch.logsumexp(logits, dim=-1, keepdim=True)
        probs = torch.exp(vals - lse)
    else:
        vals = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = cum - probs < p          # token included before crossing p
    # threshold = smallest kept logit (>= 1 token is always kept)
    thresh = torch.where(keep_sorted, vals, torch.full_like(vals, float("inf")))
    thresh = thresh.amin(dim=-1, keepdim=True)
    return logits.masked_fill(logits < thresh, NEG_INF)


def sample(
    gen: torch.Generator,
    logits: torch.Tensor,            # [B, V]
    temperature: float = 1.0,
    top_p: float = 1.0,
    top_k: int = 0,
    do_sample: bool = True,
) -> torch.Tensor:
    """-> int64 [B]. Greedy (argmax, first index on ties) when ``do_sample``
    is off or the temperature is 0."""
    if not do_sample or temperature == 0.0:
        return logits.argmax(dim=-1)
    logits = logits.float() / max(temperature, 1e-6)
    if top_k:
        logits = apply_top_k(logits, top_k)
    if top_p < 1.0:
        logits = apply_top_p(logits, top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=gen).squeeze(-1)
