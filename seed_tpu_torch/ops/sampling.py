"""Token sampling: temperature / top-k / top-p (nucleus) / greedy
(counterpart of seed_tpu/ops/sampling.py).

Draws cannot reproduce seed_tpu's jax.random streams; the filters
(apply_top_k / apply_top_p / apply_top_p_rowwise) and greedy decoding are what
match exactly. ``sample`` draws from an explicit torch.Generator.
``sample_batched`` draws from per-row counter-based streams: seed_tpu samples
token t of a request with ``fold_in(key, t)``, and what is kept here is that
property, not its bits: a row's noise is a hash of (its key, its counter, the
vocabulary index), computed on the device in integer tensor ops, so a
request's draws depend on nothing but its own key and position.
"""
from __future__ import annotations

import torch

from ..parallel.local import whole

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
    top_p_candidates: int = 0,      # 0 = exact full-vocabulary sort
) -> torch.Tensor:
    """-> int64 [B]. Greedy (argmax, first index on ties) when ``do_sample``
    is off or the temperature is 0. The logits of a sharded model (a
    DTensor, parallel/) are gathered whole first."""
    logits = whole(logits)
    if not do_sample or temperature == 0.0:
        return logits.argmax(dim=-1)
    logits = logits.float() / max(temperature, 1e-6)
    if top_k:
        logits = apply_top_k(logits, top_k)
    if top_p < 1.0:
        logits = apply_top_p(logits, top_p, candidates=top_p_candidates)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=gen).squeeze(-1)


def apply_top_p_rowwise(logits: torch.Tensor, p: torch.Tensor,
                        candidates: int = 0) -> torch.Tensor:
    """Nucleus filtering with a per-row ``p`` [B]. Rows with p >= 1 keep
    every token (the threshold degenerates to the smallest logit).
    ``candidates`` as in :func:`apply_top_p`."""
    if candidates and candidates < logits.shape[-1]:
        vals = torch.topk(logits, candidates, dim=-1).values
        lse = torch.logsumexp(logits, dim=-1, keepdim=True)
        probs = torch.exp(vals - lse)
    else:
        vals = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = cum - probs < p[:, None]
    thresh = torch.where(keep_sorted, vals, torch.full_like(vals, float("inf")))
    thresh = thresh.amin(dim=-1, keepdim=True)
    if candidates and candidates < logits.shape[-1]:
        thresh = torch.where(p[:, None] >= 1.0,
                             torch.full_like(thresh, float("-inf")), thresh)
    return logits.masked_fill(logits < thresh, NEG_INF)


# ---------------------- per-row counter-based streams -----------------------

_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (two multiply-xorshift rounds) on int64
    tensors that hold values below 2**32. int64 products wrap modulo 2**64,
    which leaves their low 32 bits right."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def fold_in(keys: torch.Tensor, ctr: torch.Tensor) -> torch.Tensor:
    """Per-row step keys [B] from per-request keys [B, 2] (two 32-bit words)
    and the request's sampled-token counters [B]: a hash of the three, so
    step t of a request is a function of (key, t) alone."""
    keys = keys.long() & _M32
    h = _mix32((ctr.long() & _M32) ^ 0x9E3779B9)
    h = _mix32(h ^ keys[:, 1])
    return _mix32(h ^ keys[:, 0])


def gumbel_noise(step_keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """[B, vocab] standard Gumbel noise, entry (b, v) a function of
    (step_keys[b], v) only: a counter-based generator in tensor ops, on the
    keys' device, with no per-row generator objects and no host calls."""
    v = torch.arange(vocab, device=step_keys.device, dtype=torch.int64)
    h = _mix32((step_keys[:, None] + v[None, :] * 0x9E3779B1) & _M32)
    h = _mix32(h ^ step_keys[:, None])
    u = ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))      # in (0, 1)
    return -torch.log(-torch.log(u))


def filter_batched(logits: torch.Tensor, temperature: torch.Tensor,
                   top_p: torch.Tensor, top_k: int = 0,
                   top_p_candidates: int = 0) -> torch.Tensor:
    """The per-row temperature scaling and top-k / top-p masks of
    :func:`sample_batched`: the logits the draw is taken from."""
    scaled = logits.float() / temperature.clamp_min(1e-6)[:, None]
    if top_k:
        scaled = apply_top_k(scaled, top_k)
    return apply_top_p_rowwise(scaled, top_p, candidates=top_p_candidates)


def sample_batched(
    key: torch.Tensor,              # [B] per-row step keys (fold_in)
    logits: torch.Tensor,           # [B, V]
    temperature: torch.Tensor,      # [B] float32
    top_p: torch.Tensor,            # [B] float32
    greedy: torch.Tensor,           # [B] bool: rows taking argmax
    top_k: int = 0,                 # shared across rows (0 = off)
    top_p_candidates: int = 0,      # 0 = exact full-vocabulary sort
) -> torch.Tensor:
    """Per-row sampling for continuous batching: every request slot carries
    its own temperature / top_p / greedy flag (only top_k is shared) and its
    own stream: row b draws with Gumbel noise keyed by ``key[b]``, so a
    seeded request reproduces exactly under any concurrent slot mix.

    -> int64 [B]."""
    arg = logits.argmax(dim=-1)
    scaled = filter_batched(logits, temperature, top_p, top_k,
                            top_p_candidates)
    samp = (scaled + gumbel_noise(key, logits.shape[-1])).argmax(dim=-1)
    return torch.where(greedy, arg, samp)
