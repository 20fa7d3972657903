"""LLaMA decoder for SEED-LLaMA (counterpart of seed_tpu/models/llama.py).

RMSNorm, rotary embeddings (half-split, HF rotate_half), SwiGLU MLP, GQA,
causal attention, and a vocabulary of 32000 text ids + 8192 image codes +
BOI/EOI padded to a multiple of 128 with the padding logits masked.
Int8-quantized projections (ops/quantization.quantize_tree) go through
``layers.linear``, so a prefill with M = batch x chunk >= 256 reaches the
int8 kernel and decode (M = batch) takes the plain dequant matmul, as in
seed_tpu.

The KV cache is preallocated at ``max_len`` and updated IN PLACE by
``prefill``/``decode_step`` (seed_tpu returns a new cache from a pure
function). Layout [L, B, H_kv, S, D] for k and v each, so the cached
attention is a batched matmul with no transpose of the cache.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..ops.attention import NEG_INF, mha, sliced_causal_mask
from ..ops.quantization import quantize_tree
from . import layers as L
from .. import resolve_device


def pad_vocab(n: int, multiple: int = 128) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 40194        # 32000 text + 8192 image codes + BOI/EOI
    dim: int = 4096
    layers: int = 32
    heads: int = 32
    kv_heads: int = 32             # < heads => GQA
    ffn_dim: int = 11008
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6          # vicuna-7b (llama1); llama2 uses 1e-5
    # context extension (modeling_llama_4_35_0.py:145-187):
    # "linear" divides positions by the factor; "ntk" rescales theta
    rope_scaling: Optional[str] = None
    rope_scaling_factor: float = 1.0

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)


# Vicuna-7B backbone of SEED-LLaMA-8B (configs/llm/seed_llama_8b.yaml)
SEED_LLAMA_8B = LlamaConfig()
# LLaMA2-13B backbone of SEED-LLaMA-14B
SEED_LLAMA_14B = LlamaConfig(dim=5120, layers=40, heads=40, kv_heads=40,
                             ffn_dim=13824, rms_eps=1e-5)
TINY_LLAMA = LlamaConfig(vocab_size=270, dim=64, layers=2, heads=4,
                         kv_heads=2, ffn_dim=128, max_seq_len=128)


@dataclass
class KVCache:
    """Preallocated KV cache, written in place.

    k, v: [L, B, H_kv, S_max, D]; valid: [B, S_max] bool, the slots that
    hold real tokens; index: tokens written so far (the write cursor)."""
    k: torch.Tensor
    v: torch.Tensor
    valid: torch.Tensor
    index: int = 0


def init_cache(cfg: LlamaConfig, batch: int, max_len: Optional[int] = None,
               dtype=torch.bfloat16, device="cuda") -> KVCache:
    device = resolve_device(device)
    S = max_len or cfg.max_seq_len
    shape = (cfg.layers, batch, cfg.kv_heads, S, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((batch, S), dtype=torch.bool, device=device))


# ------------------------------ init --------------------------------------

def init_layer(gen, cfg: LlamaConfig, dtype=torch.bfloat16, device="cuda"):
    d, hd = cfg.dim, cfg.head_dim
    kv_out = cfg.kv_heads * hd
    lin = lambda i, o: L.init_linear(gen, i, o, bias=False, dtype=dtype,
                                     device=device)
    return {
        "input_layernorm": L.init_rms_norm(d, dtype, device),
        "q_proj": lin(d, d),
        "k_proj": lin(d, kv_out),
        "v_proj": lin(d, kv_out),
        "o_proj": lin(d, d),
        "post_attention_layernorm": L.init_rms_norm(d, dtype, device),
        "gate_proj": lin(d, cfg.ffn_dim),
        "up_proj": lin(d, cfg.ffn_dim),
        "down_proj": lin(cfg.ffn_dim, d),
    }


@torch.no_grad()
def init_llama(gen: torch.Generator, cfg: LlamaConfig, dtype=torch.bfloat16,
               device="cuda", quantize_targets: Optional[str] = None):
    """Seeded random weights on ``device`` (the card by default).

    With ``quantize_targets`` (e.g. ops.quantization.DEFAULT_TARGETS) each
    layer, and the lm_head, is quantized as soon as it is made, so the
    full-precision model is never held whole: the 8B int8 serving tree
    builds in ~7 GB instead of passing through a 13 GB bf16 copy."""
    device = resolve_device(device)
    q = ((lambda t: quantize_tree(t, quantize_targets)) if quantize_targets
         else (lambda t: t))
    params = {
        "embed_tokens": L.init_embed(gen, cfg.padded_vocab, cfg.dim, dtype,
                                     device=device),
        "layers": [q(init_layer(gen, cfg, dtype, device))
                   for _ in range(cfg.layers)],
        "norm": L.init_rms_norm(cfg.dim, dtype, device),
    }
    head = {"lm_head": L.init_linear(gen, cfg.dim, cfg.padded_vocab,
                                     bias=False, dtype=dtype, device=device)}
    params.update(q(head))
    return params


# ------------------------------ rope ---------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
         scaling: Optional[str] = None, factor: float = 1.0) -> torch.Tensor:
    """Rotary embedding, half-split pairing (HF llama rotate_half).
    x [B, N, H, D], positions [B, N] or [N]."""
    D = x.shape[-1]
    if scaling == "ntk" and factor != 1.0:
        theta = theta * (factor ** (D / max(1, D - 2)))
    exps = torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D
    inv = 1.0 / (theta ** exps)
    pos = positions.float()
    if scaling == "linear" and factor != 1.0:
        pos = pos / factor
    if pos.dim() == 1:
        pos = pos[None, :]
    freqs = pos[..., None] * inv          # [B, N, D/2]
    cos = torch.cos(freqs)[:, :, None, :]
    sin = torch.sin(freqs)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------- layer forward -------------------------------

def _attn_qkv(p, x, positions, cfg: LlamaConfig):
    """Pre-LN + q/k/v projections + RoPE."""
    B, N, _ = x.shape
    hd = cfg.head_dim
    h = L.rms_norm(p["input_layernorm"], x, cfg.rms_eps)
    q = L.linear(p["q_proj"], h).reshape(B, N, cfg.heads, hd)
    k = L.linear(p["k_proj"], h).reshape(B, N, cfg.kv_heads, hd)
    v = L.linear(p["v_proj"], h).reshape(B, N, cfg.kv_heads, hd)
    q = rope(q, positions, cfg.rope_theta, cfg.rope_scaling,
             cfg.rope_scaling_factor)
    k = rope(k, positions, cfg.rope_theta, cfg.rope_scaling,
             cfg.rope_scaling_factor)
    return q, k, v


def _attn_out_mlp(p, x, o, cfg: LlamaConfig):
    """o_proj residual + post-LN + SwiGLU MLP."""
    B, N, _ = x.shape
    x = x + L.linear(p["o_proj"], o.reshape(B, N, cfg.dim))
    h = L.rms_norm(p["post_attention_layernorm"], x, cfg.rms_eps)
    gate = torch.nn.functional.silu(L.linear(p["gate_proj"], h))
    return x + L.linear(p["down_proj"], gate * L.linear(p["up_proj"], h))


def _cached_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Attention of q [B, N, H, D] over one layer's cache k/v
    [B, H_kv, S, D]; mask broadcastable to [B, 1, N, S]. fp32 scores and
    softmax, probabilities rounded to q's type (mha numerics). GQA: query
    heads grouped [H_kv, G] against their shared kv head."""
    B, N, H, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    qg = q.reshape(B, N, Hkv, G, D).permute(0, 2, 3, 1, 4)   # [B, Hkv, G, N, D]
    kt = k.to(q.dtype)[:, :, None].float().transpose(-1, -2)  # [B, Hkv, 1, D, S]
    scores = torch.matmul(qg.float(), kt) * (D ** -0.5)       # [B, Hkv, G, N, S]
    scores = scores.masked_fill(~mask[:, :, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.matmul(probs, v.to(q.dtype)[:, :, None])         # [B, Hkv, G, N, D]
    return o.permute(0, 3, 1, 2, 4).reshape(B, N, H * D)


def _logits(params, x, cfg: LlamaConfig) -> torch.Tensor:
    x = L.rms_norm(params["norm"], x, cfg.rms_eps)
    logits = L.linear(params["lm_head"], x).float()
    if cfg.padded_vocab != cfg.vocab_size:  # mask vocab padding
        logits[..., cfg.vocab_size:] = NEG_INF
    return logits


# ----------------------------- public API ----------------------------------

def forward(params, input_ids: torch.Tensor, cfg: LlamaConfig,
            positions: Optional[torch.Tensor] = None,
            attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Forward over a full sequence -> logits [B, N, V]. ``attn_mask`` [B, N]
    (1 = real token) combines with the causal mask."""
    B, N = input_ids.shape
    x = L.embed(params["embed_tokens"], input_ids)
    if positions is None:
        positions = torch.arange(N, device=input_ids.device)
    mask = sliced_causal_mask(N, N, 0, input_ids.device)
    if attn_mask is not None:
        mask = mask & attn_mask[:, None, None, :].bool()
    for lp in params["layers"]:
        q, k, v = _attn_qkv(lp, x, positions, cfg)
        x = _attn_out_mlp(lp, x, mha(q, k, v, mask=mask), cfg)
    return _logits(params, x, cfg)


def prefill(params, input_ids: torch.Tensor, cache: KVCache, cfg: LlamaConfig,
            chunk_mask: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, KVCache]:
    """Write a chunk into the cache at ``cache.index`` (in place) and return
    the chunk's logits [B, N, V] and the cache.

    Left-padding-aware: ``chunk_mask`` [B, N] marks real tokens; RoPE
    positions count the real tokens already cached per row (HF
    position_ids = cumsum(mask)), and attention sees only valid slots.
    Decode is the N=1 case."""
    B, N = input_ids.shape
    S = cache.k.shape[3]
    start = cache.index
    if start + N > S:
        raise ValueError(f"prefill: {start} + {N} tokens overflow the cache "
                         f"of {S}")
    dev = input_ids.device
    if chunk_mask is None:
        chunk_mask = torch.ones((B, N), dtype=torch.int64, device=dev)
    chunk_mask = chunk_mask.long()

    x = L.embed(params["embed_tokens"], input_ids)
    prior = cache.valid.sum(dim=1)                                   # [B]
    positions = (prior[:, None] + chunk_mask.cumsum(dim=1) - 1).clamp_min(0)
    cache.valid[:, start:start + N] = chunk_mask.bool()
    mask = (sliced_causal_mask(N, S, start, dev)
            & cache.valid[:, None, None, :])                        # [B,1,N,S]

    for i, lp in enumerate(params["layers"]):
        q, k, v = _attn_qkv(lp, x, positions, cfg)
        cache.k[i, :, :, start:start + N] = k.transpose(1, 2).to(cache.k.dtype)
        cache.v[i, :, :, start:start + N] = v.transpose(1, 2).to(cache.v.dtype)
        o = _cached_attn(q, cache.k[i], cache.v[i], mask)
        x = _attn_out_mlp(lp, x, o, cfg)
    cache.index = start + N
    return _logits(params, x, cfg), cache


def decode_step(params, input_ids: torch.Tensor, cache: KVCache,
                cfg: LlamaConfig) -> Tuple[torch.Tensor, KVCache]:
    """One autoregressive step: ids [B, 1] -> logits [B, 1, V]; the cache is
    updated in place."""
    return prefill(params, input_ids, cache, cfg)
