"""Plain fp32 reference of a LLaMA-architecture decoder (RMSNorm, rotary
embeddings with HF's rotate_half pairing, causal multi-head attention with
grouped kv heads, SwiGLU MLP, untied lm_head), in plain PyTorch with TF32
off. It imports nothing of the program: it reads the benchmark's own
weights (int8 codes and fp32 scales, bf16 embedding and norms) and
dequantizes them itself, one layer at a time.

It runs each whole sequence (prompt and served tokens) at once, with no
cache, no buckets and no batching across requests, and reads the logits at
the positions that produced the served tokens. A greedy token is judged by
how far its logit lies below the best; a sampled one by the probability
mass, at the request's temperature, of the tokens above it: top-p keeps a
token only where that mass is under p.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

FP8_MAX = 448.0


def _fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """x rounded to fp8 e4m3 with one scale per row (the control)."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [S, H, D]; cos, sin [S, 1, D/2]."""
    a, b = x.chunk(2, dim=-1)
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _deq(p: dict) -> torch.Tensor:
    return p["kernel_q"].float() * p["scale"].float()[None, :]


def _layer(x, lw: dict, w: dict, spec, cos, sin, act) -> torch.Tensor:
    """One decoder layer over a whole sequence x [S, dim]. ``act`` rounds
    every matrix product's activation operand (the control's fp8; the
    identity for the reference): the projections' inputs, q, k, v and the
    attention probabilities."""
    S = x.shape[0]
    H, Hkv, hd = spec.heads, spec.kv_heads, spec.dim // spec.heads
    lin = lambda t, name: act(t) @ w[name]
    h = _rms(x, lw["input_layernorm"]["scale"], spec.rms_eps)
    q = act(_rope(lin(h, "q_proj").view(S, H, hd), cos, sin))
    k = act(_rope(lin(h, "k_proj").view(S, Hkv, hd), cos, sin))
    v = act(lin(h, "v_proj").view(S, Hkv, hd))
    g = H // Hkv
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    scores = torch.einsum("shd,thd->hst", q, k) * hd ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    p = act(scores.softmax(-1))
    o = torch.einsum("hst,thd->shd", p, v).reshape(S, -1)
    x = x + lin(o, "o_proj")
    h = _rms(x, lw["post_attention_layernorm"]["scale"], spec.rms_eps)
    gate = torch.nn.functional.silu(lin(h, "gate_proj"))
    return x + lin(gate * lin(h, "up_proj"), "down_proj")


@torch.no_grad()
def logits_at(weights: dict, spec, seqs: Sequence[List[int]],
              reads: Sequence[List[int]], device,
              control: bool = False) -> List[torch.Tensor]:
    """fp32 logits [len(read), V] of each sequence at positions ``read``.
    ``control`` computes the reference one precision below the served
    bf16: every matrix product's activation operand rounded to fp8 e4m3,
    one scale per row (the int8 weights stay exact)."""
    act = _fp8_rows if control else (lambda t: t)
    emb = weights["embed_tokens"]["embedding"]
    xs = [emb[torch.tensor(s, device=device)].float() for s in seqs]
    hd = spec.dim // spec.heads
    inv = 1.0 / spec.rope_theta ** (torch.arange(0, hd, 2, device=device,
                                                 dtype=torch.float64) / hd)
    longest = max(len(s) for s in seqs)
    ang = torch.arange(longest, device=device, dtype=torch.float64)[:, None] * inv
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
    for lw in weights["layers"]:
        w = {n: _deq(lw[n]) for n in ("q_proj", "k_proj", "v_proj", "o_proj",
                                      "gate_proj", "up_proj", "down_proj")}
        xs = [_layer(x, lw, w, spec, cos[:len(x)], sin[:len(x)], act)
              for x in xs]
        del w
    head = _deq(weights["lm_head"])
    out = []
    for x, r in zip(xs, reads):
        h = _rms(x[torch.tensor(r, device=device)], weights["norm"]["scale"],
                 spec.rms_eps)
        out.append(act(h) @ head)
    return out


def mass_above(logits: torch.Tensor, tok: torch.Tensor,
               temperature: float) -> torch.Tensor:
    """The probability at ``temperature`` of the tokens whose logit is above
    each row's token ``tok`` [rows]: under top-p the token is kept where
    this is under p."""
    probs = (logits / temperature).softmax(-1)
    own = logits.gather(1, tok[:, None].long())
    return (probs * (logits > own)).sum(-1)


def nucleus_floor(logits: torch.Tensor, temperature: float,
                  top_p: float) -> torch.Tensor:
    """The smallest logit in each row's nucleus [rows]: the tokens, most
    probable first at ``temperature``, whose preceding probability mass is
    under ``top_p`` (the token that crosses p is in it)."""
    vals = logits.sort(dim=-1, descending=True).values
    probs = (vals / temperature).softmax(-1)
    inside = probs.cumsum(-1) - probs < top_p
    return vals.masked_fill(~inside, float("inf")).amin(-1)


def _draw(logits: torch.Tensor, temperature: float, top_p: float,
          gen: torch.Generator) -> torch.Tensor:
    """One token a row from the nucleus at ``temperature`` (Gumbel-max)."""
    floor = nucleus_floor(logits, temperature, top_p)[:, None]
    z = (logits / temperature).masked_fill(logits < floor, float("-inf"))
    u = torch.rand(z.shape, generator=gen, device=z.device).clamp_(1e-20, 1.0)
    return (z - (-u.log()).log()).argmax(-1)


Picked = Sequence[Tuple[list, list, int]]


def compare(weights: dict, spec, greedy: Picked, sampled: Picked,
            temperature: float, top_p: float, device,
            control: bool = False, seed: int = 0) -> dict:
    """The served tokens against the reference.

    ``greedy``, ``sampled``: (prompt, served tokens, index of the first
    token the model computed) of greedy and of sampled requests. A greedy
    token's gap is by how far its reference logit lies below the
    reference's best at that position: ``logit_gap`` the widest,
    ``mean_gap`` the mean. A sampled token's is by how far the reference's
    probability mass above it (at ``temperature``) exceeds ``top_p``, 0 in
    the reference's nucleus: ``nucleus_excess`` the mean, ``outside_share``
    the share outside. With ``control`` the tokens are those of the
    lower-precision reference at the same positions: its first at a greedy
    position, a draw from its own nucleus (noise seeded with ``seed``) at a
    sampled one."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        picked = list(greedy) + list(sampled)
        ng = len(greedy)
        seqs = [p + t[:-1] for p, t, _ in picked]
        reads = [[len(p) - 1 + j for j in range(f, len(t))]
                 for p, t, f in picked]
        ref = logits_at(weights, spec, seqs, reads, device)
        if control:
            low = logits_at(weights, spec, seqs, reads, device, control=True)
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            toks = ([lg.argmax(-1) for lg in low[:ng]]
                    + [_draw(lg, temperature, top_p, gen) for lg in low[ng:]])
        else:
            toks = [torch.tensor(t[f:], device=device) for _, t, f in picked]
        at = lambda lg, tk: lg.gather(1, tk[:, None].long())[:, 0]
        out = {}
        if greedy:
            g = torch.cat([lg.max(-1).values - at(lg, tk)
                           for lg, tk in zip(ref[:ng], toks[:ng])])
            out.update(logit_gap=float(g.max()), mean_gap=float(g.mean()),
                       compared_tokens=int(g.numel()))
        if sampled:
            n = torch.cat([(mass_above(lg, tk, temperature)
                            - top_p).clamp_min(0)
                           for lg, tk in zip(ref[ng:], toks[ng:])])
            out.update(nucleus_excess=float(n.mean()),
                       outside_share=float((n > 0).float().mean()),
                       sampled_tokens=int(n.numel()))
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
