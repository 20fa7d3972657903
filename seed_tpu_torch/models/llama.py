"""LLaMA decoder for SEED-LLaMA (counterpart of seed_tpu/models/llama.py).

RMSNorm, rotary embeddings (half-split, HF rotate_half), SwiGLU MLP, GQA,
causal attention, and a vocabulary of 32000 text ids + 8192 image codes +
BOI/EOI padded to a multiple of 128 with the padding logits masked.
Int8-quantized projections (ops/quantization.quantize_tree) go through
``layers.linear``, so a prefill with M = batch x chunk >= 256 reaches the
int8 kernel and decode (M = batch) takes the plain dequant matmul, as in
seed_tpu; under ``LlamaConfig.w8a8`` they go through ``layers.linear_w8a8``
(dynamic int8 activations, the w8a8 kernel).

The KV cache is preallocated at ``max_len`` and updated IN PLACE by
``prefill``/``decode_step`` (seed_tpu returns a new cache from a pure
function). Layout [L, B, H_kv, S, D] for k and v each, so the cached
attention is a batched matmul with no transpose of the cache. It holds bf16
(or fp32), fp8 e4m3 (a cast on write and on read) or int8 codes with a
per-(token, kv head, k|v) fp32 absmax scale.

``SlotCache`` and the ``slot_*`` programs are the substrate of continuous
batching: every batch row is a request slot with its own length, filled and
evicted independently; the slot rows are written in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.attention import NEG_INF, mha, sliced_causal_mask
from ..ops.flash_attention import flash_attention
from ..ops.quantization import quantize_tree
from ..ops.sampling import fold_in, sample, sample_batched
from ..parallel.local import local_count, on_local_shards
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
    # W8A8 serving: int8-quantized projections take dynamic per-token int8
    # activations through the int8 tensor cores (layers.linear_w8a8), so the
    # weights are read as int8 with no bf16 copy. Lossy (activation
    # quantization error): a serving opt-in.
    w8a8: bool = False

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
# ~0.4B: the full SEED vocabulary and the 8B layer anatomy at reduced width
# and depth (train_llm --model small)
SMALL_LLAMA = LlamaConfig(vocab_size=40194, dim=1024, layers=8, heads=8,
                          kv_heads=8, ffn_dim=2816, max_seq_len=1024)

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0     # e4m3fn has no infinity; its largest finite value


@dataclass
class KVCache:
    """Preallocated KV cache, written in place.

    k, v: [L, B, H_kv, S_max, D]; valid: [B, S_max] bool, the slots that
    hold real tokens; index: tokens written so far (the write cursor).

    Quantized modes, both at half the bytes of bf16:

    - fp8 (``init_cache(dtype=torch.float8_e4m3fn)``): scale-free, a cast on
      write and a cast on read.
    - int8 (``dtype=torch.int8``): codes plus ``scale`` [L, B, H_kv, S_max, 2]
      fp32, the absmax scale of each cached k (index 0) and v (index 1)
      vector. More precise than e4m3's 3-bit mantissa."""
    k: torch.Tensor
    v: torch.Tensor
    valid: torch.Tensor
    index: int = 0
    scale: Optional[torch.Tensor] = None


def _raw(t: torch.Tensor) -> torch.Tensor:
    """fp8 tensors as their bytes: copies, gathers and indexed writes are
    not implemented for fp8 on every build, and need no arithmetic."""
    return t.view(torch.uint8) if t.dtype == FP8 else t


def _cache_cast(x: torch.Tensor, dtype) -> torch.Tensor:
    """Float values in a cache's storage type. To fp8 the value is rounded
    once, from fp32 (bf16 -> fp32 is exact), and saturates at +-448: what a
    cast gives above that differs between builds (448 or NaN), so the clamp
    makes it one defined result. seed_tpu's cast agrees up to 464, the last
    value that rounds to 448, and gives NaN above."""
    if dtype == FP8:
        return x.float().clamp(-FP8_MAX, FP8_MAX).to(FP8)
    return x.to(dtype)


def _cache_kv_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., D] float vectors -> (int8 codes, [...] fp32 absmax scales)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _cache_kv_dequant(c: torch.Tensor, scale: Optional[torch.Tensor],
                      dtype=torch.bfloat16) -> torch.Tensor:
    """Stored k or v (+ its scales when int8) -> values in ``dtype``. One
    pass either way: the int8 product is computed in fp32 and rounded to
    ``dtype`` as it is written."""
    if scale is None:
        return c.to(dtype)
    out = torch.empty(c.shape, dtype=dtype, device=c.device)
    return torch.mul(c, scale[..., None], out=out)


def cache_kv_heads(params, cfg: LlamaConfig) -> int:
    """The kv heads of ``params`` one rank computes: ``cfg.kv_heads``, or
    its share of them when the tree is sharded over ``tensor``
    (parallel.shard_params with LLAMA_TP_RULES), so that a rank's cache
    holds its own heads only."""
    kp = params["layers"][0]["k_proj"]
    return local_count(cfg.kv_heads, kp.get("kernel", kp.get("kernel_q")))


def init_cache(cfg: LlamaConfig, batch: int, max_len: Optional[int] = None,
               dtype=torch.bfloat16, device="cuda",
               kv_heads: Optional[int] = None) -> KVCache:
    """A zeroed cache of ``kv_heads`` heads (``cfg.kv_heads`` unless given:
    a rank of a sharded engine holds ``cache_kv_heads``)."""
    device = resolve_device(device)
    S = max_len or cfg.max_seq_len
    shape = (cfg.layers, batch, kv_heads or cfg.kv_heads, S, cfg.head_dim)
    scale = None
    if dtype == torch.int8:
        scale = torch.zeros(shape[:-1] + (2,), dtype=torch.float32,
                            device=device)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((batch, S), dtype=torch.bool, device=device),
                   0, scale)


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

def _lin(p, x, cfg: LlamaConfig):
    """cfg.w8a8 routes int8-quantized projections through the int8 x int8
    product (weights read as int8); otherwise the weight-only/bf16 path."""
    if cfg.w8a8 and "kernel_q" in p:
        return L.linear_w8a8(p, x)
    return L.linear(p, x)


def _attn_qkv(p, x, positions, cfg: LlamaConfig):
    """Shared front half of every decoder-layer variant (batch forward,
    ring-cache prefill, all slot paths): pre-LN + q/k/v projections + RoPE."""
    B, N, _ = x.shape
    hd = cfg.head_dim
    h = L.rms_norm(p["input_layernorm"], x, cfg.rms_eps)
    q = _lin(p["q_proj"], h, cfg).reshape(B, N, cfg.heads, hd)
    k = _lin(p["k_proj"], h, cfg).reshape(B, N, cfg.kv_heads, hd)
    v = _lin(p["v_proj"], h, cfg).reshape(B, N, cfg.kv_heads, hd)
    q = rope(q, positions, cfg.rope_theta, cfg.rope_scaling,
             cfg.rope_scaling_factor)
    k = rope(k, positions, cfg.rope_theta, cfg.rope_scaling,
             cfg.rope_scaling_factor)
    return q, k, v


def _attn_out_mlp(p, x, o, cfg: LlamaConfig):
    """Shared back half of every decoder-layer variant: o_proj residual +
    post-LN + SwiGLU MLP."""
    B, N, _ = x.shape
    x = x + _lin(p["o_proj"], o.reshape(B, N, cfg.dim), cfg)
    h = L.rms_norm(p["post_attention_layernorm"], x, cfg.rms_eps)
    gate = torch.nn.functional.silu(_lin(p["gate_proj"], h, cfg))
    return x + _lin(p["down_proj"], gate * _lin(p["up_proj"], h, cfg), cfg)


def _cached_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor,
                 scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of q [B, N, H, D] over one layer's cache k/v
    [B, H_kv, S, D] (``scale`` [B, H_kv, S, 2] when they are int8 codes);
    mask broadcastable to [B, 1, N, S]. The cache is dequantized to q's type
    in the same pass that converts it, then fp32 scores and softmax,
    probabilities rounded to q's type (mha numerics). GQA: query heads
    grouped [H_kv, G] against their shared kv head."""
    B, N, H, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    ks, vs = (None, None) if scale is None else (scale[..., 0], scale[..., 1])
    if scale is None and k.dtype in (FP8, q.dtype):
        # every stored value is exact in q's type, so the rounding to it is
        # the identity: one conversion, straight to fp32
        kf = k.float()
    else:
        kf = _cache_kv_dequant(k, ks, q.dtype).float()
    v = _cache_kv_dequant(v, vs, q.dtype)
    qg = q.reshape(B, N, Hkv, G, D).permute(0, 2, 3, 1, 4)   # [B, Hkv, G, N, D]
    kt = kf[:, :, None].transpose(-1, -2)                     # [B, Hkv, 1, D, S]
    scores = torch.matmul(qg.float(), kt) * (D ** -0.5)       # [B, Hkv, G, N, S]
    scores = scores.masked_fill(~mask[:, :, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.matmul(probs, v[:, :, None])                    # [B, Hkv, G, N, D]
    return o.permute(0, 3, 1, 2, 4).reshape(B, N, H * D)


def _logits(params, x, cfg: LlamaConfig) -> torch.Tensor:
    x = L.rms_norm(params["norm"], x, cfg.rms_eps)
    logits = _lin(params["lm_head"], x, cfg).float()
    if cfg.padded_vocab != cfg.vocab_size:  # mask vocab padding
        # out of place: for fp32 weights .float() is the matmul's own output,
        # a tensor inside the autograd graph when training
        pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, NEG_INF)
    return logits


# ----------------------------- public API ----------------------------------

def layer_apply(lp, x: torch.Tensor, positions: torch.Tensor,
                mask: Optional[torch.Tensor], cfg: LlamaConfig,
                use_flash: bool = False, attn_fn=None) -> torch.Tensor:
    """One decoder layer over a full sequence (seed_tpu's cache-less
    ``_layer_apply``): ``attn_fn(q, k, v) -> [B, N, H, D]``, when given,
    replaces the attention; else the flash kernels or ``mha`` under
    ``mask``."""
    q, k, v = _attn_qkv(lp, x, positions, cfg)
    if attn_fn is not None:
        o = attn_fn(q, k, v)
    elif use_flash:
        o = flash_attention(q, k, v, causal=True)
    else:
        o = mha(q, k, v, mask=mask)
    return _attn_out_mlp(lp, x, o, cfg)


def forward(params, input_ids: torch.Tensor, cfg: LlamaConfig,
            positions: Optional[torch.Tensor] = None,
            attn_mask: Optional[torch.Tensor] = None,
            remat: bool = False, use_flash: bool = False,
            attn_fn=None) -> torch.Tensor:
    """Training/eval forward over a full sequence -> logits [B, N, V],
    differentiable in every floating-point leaf of ``params``.

    ``attn_mask`` [B, N] (1 = real token) combines with the causal mask.
    ``use_flash`` routes attention through ``flash_attention(causal=True)``,
    the tiled flash kernels and their backward kernels (right padding
    assumed: real tokens never attend forward into padding, and padded
    positions carry no loss; ``attn_mask`` then only matters on the loss
    side). ``attn_fn`` replaces attention entirely (sequence-parallel ring
    attention, which owns its causal masking across shards: with it, a
    ``attn_mask`` raises). ``remat`` keeps only each layer's input for the
    backward pass and recomputes the layer there (``torch.utils.checkpoint``,
    non-reentrant), as seed_tpu's ``jax.checkpoint`` per layer does."""
    B, N = input_ids.shape
    x = L.embed(params["embed_tokens"], input_ids)
    if positions is None:
        positions = torch.arange(N, device=input_ids.device)
    if attn_fn is not None:
        if attn_mask is not None:
            raise ValueError(
                "attn_fn owns masking entirely (sequence-parallel shards "
                "cannot see a global [B, N] mask); fold padding into the "
                "loss labels instead of passing attn_mask with attn_fn")
        mask = None
    else:
        mask = sliced_causal_mask(N, N, 0, input_ids.device)
        if attn_mask is not None:
            mask = mask & attn_mask[:, None, None, :].bool()

    def layer(lp, xx):
        return layer_apply(lp, xx, positions, mask, cfg, use_flash, attn_fn)

    for lp in params["layers"]:
        x = (checkpoint(layer, lp, x, use_reentrant=False) if remat
             else layer(lp, x))
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

    sl = slice(start, start + N)
    for i, lp in enumerate(params["layers"]):
        q, k, v = _attn_qkv(lp, x, positions, cfg)
        # a sharded model's q/k/v (DTensors) meet the cache on each rank's
        # own heads: the cache holds those heads only (``cache_kv_heads``)
        o = on_local_shards(_write_and_attend, q, k, v, split_rows=False,
                            cache=cache, layer=i, sl=sl, mask=mask)
        x = _attn_out_mlp(lp, x, o, cfg)
    cache.index = start + N
    return _logits(params, x, cfg), cache


def _write_and_attend(q, k, v, cache: KVCache, layer: int, sl: slice,
                      mask: torch.Tensor) -> torch.Tensor:
    """Write the chunk's k/v [B, N, H_kv, D] into ``layer``'s cache at
    ``sl``, then attend q [B, N, H, D] over the stored cache, the chunk just
    written included; -> [B, N, H, D]."""
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)           # [B, H_kv, N, D]
    i = layer
    if cache.scale is not None:                             # int8: quantize
        cache.k[i, :, :, sl], cache.scale[i, :, :, sl, 0] = _cache_kv_quant(kt)
        cache.v[i, :, :, sl], cache.scale[i, :, :, sl, 1] = _cache_kv_quant(vt)
    else:
        _raw(cache.k)[i, :, :, sl] = _raw(_cache_cast(kt, cache.k.dtype))
        _raw(cache.v)[i, :, :, sl] = _raw(_cache_cast(vt, cache.v.dtype))
    o = _cached_attn(q, cache.k[i], cache.v[i], mask,
                     None if cache.scale is None else cache.scale[i])
    return o.reshape(q.shape)


def decode_step(params, input_ids: torch.Tensor, cache: KVCache,
                cfg: LlamaConfig) -> Tuple[torch.Tensor, KVCache]:
    """One autoregressive step: ids [B, 1] -> logits [B, 1, V]; the cache is
    updated in place."""
    return prefill(params, input_ids, cache, cfg)


def decode_loop(params, tok: torch.Tensor, cache: KVCache,
                rng: torch.Generator, cfg: LlamaConfig, *, steps: int,
                temperature: float = 1.0, top_p: float = 1.0, top_k: int = 0,
                do_sample: bool = True, eos_id: int = 2
                ) -> Tuple[torch.Tensor, torch.Tensor, KVCache, torch.Generator]:
    """``steps`` decode + sample iterations with no host round trip between
    them: sampling runs on the device and nothing is read back.

    ``tok`` [B] is the previously sampled token (not yet decoded). Rows that
    hit ``eos_id`` keep decoding in lockstep but their later outputs are
    pinned to ``eos_id``, so the host can strip them.

    Returns (tokens [B, steps], done [B] bool, cache, rng)."""
    done = tok == eos_id
    toks = []
    for _ in range(steps):
        logits, cache = prefill(params, tok[:, None], cache, cfg)
        nxt = sample(rng, logits[:, 0], temperature, top_p, top_k, do_sample)
        nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
        done = done | (nxt == eos_id)
        toks.append(nxt)
        tok = nxt
    if not toks:
        return tok.new_zeros((tok.shape[0], 0)), done, cache, rng
    return torch.stack(toks, dim=1), done, cache, rng


_BEAM_NEG = -1.0e30   # fp32-safe "-inf" for dead beams


def gather_cache_rows(cache: KVCache, rows: torch.Tensor) -> KVCache:
    """The cache with batch row ``rows[j]`` at row j (beam reordering, and
    the K-fold expansion before a beam search); the int8 scales follow."""
    return KVCache(
        _raw(cache.k).index_select(1, rows).view(cache.k.dtype),
        _raw(cache.v).index_select(1, rows).view(cache.v.dtype),
        cache.valid.index_select(0, rows), cache.index,
        None if cache.scale is None else cache.scale.index_select(1, rows))


def beam_loop(params, tok0: torch.Tensor, scores0: torch.Tensor,
              cache: KVCache, cfg: LlamaConfig, *, steps: int,
              eos_id: int = 2, length_penalty: float = 1.0
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Beam search over the ring cache, entirely on the device.

    Each step scores all K*V continuations in fp32, takes the top K as the
    next beams, and gathers the cache rows by beam index.

    - beams that emit ``eos_id`` freeze: score and generated length stop
      accumulating (their only continuation is eos at logp 0);
    - after ``steps`` iterations every beam (finished at its eos, alive at
      the horizon) is ranked by ``cum_logprob / len**length_penalty`` where
      ``len`` counts generated tokens including the eos.

    Args:
      tok0:    [B, K] first generated token per beam (already scored).
      scores0: [B, K] fp32 cumulative logprob of that first token
               (non-viable duplicate beams carry about -1e30).
      cache:   KVCache with B*K rows, beam (b, k) at row b*K + k, the prompt
               prefilled into every row.

    Returns (tokens [B, K, steps+1], norm_scores [B, K], gen_len [B, K])."""
    B, K = tok0.shape
    dev = tok0.device
    tok = tok0.long()
    scores = scores0.float()
    hist = torch.zeros((B, K, steps + 1), dtype=torch.int64, device=dev)
    hist[:, :, 0] = tok
    finished = tok == eos_id
    gen_len = torch.ones((B, K), dtype=torch.int64, device=dev)
    base = torch.arange(B, device=dev)[:, None] * K
    for t in range(1, steps + 1):
        logits, cache = prefill(params, tok.reshape(B * K, 1), cache, cfg)
        V = logits.shape[-1]
        logp = torch.log_softmax(logits[:, 0].float(), dim=-1).reshape(B, K, V)
        # finished beams continue ONLY as eos at logp 0 (score frozen)
        eos_only = torch.full((V,), _BEAM_NEG, dtype=torch.float32, device=dev)
        eos_only[eos_id] = 0.0
        logp = torch.where(finished[..., None], eos_only, logp)
        cand = (scores[..., None] + logp).reshape(B, K * V)
        scores, idx = torch.topk(cand, K, dim=-1)                # [B, K]
        src = idx // V
        tok = idx % V
        finished = finished.gather(1, src)
        gen_len = gen_len.gather(1, src)
        hist = hist.gather(1, src[..., None].expand(B, K, steps + 1))
        cache = gather_cache_rows(cache, (base + src).reshape(-1))
        gen_len = torch.where(finished, gen_len, gen_len + 1)
        finished = finished | (tok == eos_id)
        hist[:, :, t] = tok
    norm = scores / gen_len.float().pow(length_penalty)
    return hist, norm, gen_len


# --------------------- per-slot cache (continuous batching) -----------------

@dataclass
class SlotCache:
    """KV cache with per-slot write positions: each batch row is an
    independent request slot that can be filled and evicted at any time
    (left-aligned occupancy per slot; no global cursor). bf16 or fp8 (a cast
    on write and on read; there is no int8 mode).

    k, v: [L, B, H_kv, S, D], the ring cache's layout, so the slot programs
    share ``_cached_attn``; length: [B] int64, tokens held per slot. Every
    slot program writes its rows in place and touches no other slot."""
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor


def init_slot_cache(cfg: LlamaConfig, slots: int,
                    max_len: Optional[int] = None, dtype=torch.bfloat16,
                    device="cuda") -> SlotCache:
    device = resolve_device(device)
    if dtype == torch.int8:
        raise ValueError("the slot cache is bf16, fp32 or fp8: it has no "
                         "int8 mode")
    S = max_len or cfg.max_seq_len
    shape = (cfg.layers, slots, cfg.kv_heads, S, cfg.head_dim)
    return SlotCache(torch.zeros(shape, dtype=dtype, device=device),
                     torch.zeros(shape, dtype=dtype, device=device),
                     torch.zeros((slots,), dtype=torch.int64, device=device))


def _slot_write(cache: SlotCache, layer: int, slot: int, start: int,
                k: torch.Tensor, v: torch.Tensor) -> None:
    """A chunk's k, v [1, N, H_kv, D] into one slot's rows [start, start+N)."""
    sl = slice(start, start + k.shape[1])
    _raw(cache.k)[layer, slot, :, sl] = _raw(
        _cache_cast(k[0].transpose(0, 1), cache.k.dtype))
    _raw(cache.v)[layer, slot, :, sl] = _raw(
        _cache_cast(v[0].transpose(0, 1), cache.v.dtype))


def _last_logits(params, x: torch.Tensor, n_tokens: int,
                 cfg: LlamaConfig) -> torch.Tensor:
    """Next-token logits [1, V] of a right-padded chunk: only the last real
    token's row goes through the final norm and the lm_head."""
    return _logits(params, x[:, n_tokens - 1:n_tokens], cfg)[:, 0]


def slot_prefill(params, input_ids: torch.Tensor, n_tokens: int, slot: int,
                 cache: SlotCache, cfg: LlamaConfig
                 ) -> Tuple[torch.Tensor, SlotCache]:
    """Prefill ONE slot with a right-padded prompt [1, N] holding
    ``n_tokens`` real tokens; other slots untouched. Returns the slot's
    next-token logits [1, V] and the cache.

    Only rows [0, N) of the slot are written; stale tokens beyond the new
    length are never attended (every mask is bounded by the slot length,
    and decode writes position ``length`` before reading it). The start=0
    fast path: attention runs over the chunk and never reads the cache."""
    N = input_ids.shape[1]
    if N > cache.k.shape[3]:
        raise ValueError(f"slot_prefill: chunk of {N} overflows the cache")
    dev = input_ids.device
    x = L.embed(params["embed_tokens"], input_ids)
    positions = torch.arange(N, device=dev)[None, :]
    col = torch.arange(N, device=dev)[None, :]
    row = torch.arange(N, device=dev)[:, None]
    mask = ((col <= row) & (col < n_tokens))[None, None]
    for i, lp in enumerate(params["layers"]):
        q, kk, vv = _attn_qkv(lp, x, positions, cfg)
        # the fresh k, v in the cache's layout, through the same attention
        # as slot_prefill_at, so a prefix hit and a from-0 prefill run the
        # same operations on the same values (mha numerics either way)
        o = _cached_attn(q, kk.transpose(1, 2), vv.transpose(1, 2), mask)
        x = _attn_out_mlp(lp, x, o, cfg)
        _slot_write(cache, i, slot, 0, kk, vv)
    cache.length[slot] = n_tokens
    return _last_logits(params, x, n_tokens, cfg), cache


def install_prefix(prefix_kv: Tuple[torch.Tensor, torch.Tensor], slot: int,
                   cache: SlotCache) -> SlotCache:
    """Copy a precomputed prefix's k, v ([L, H_kv, P, D] each) into one
    slot's rows [0, P); the slot length is set by the follow-up
    :func:`slot_prefill_at`."""
    pk, pv = prefix_kv
    P = pk.shape[2]
    _raw(cache.k)[:, slot, :, :P] = _raw(_cache_cast(pk, cache.k.dtype))
    _raw(cache.v)[:, slot, :, :P] = _raw(_cache_cast(pv, cache.v.dtype))
    return cache


def slot_prefill_at(params, input_ids: torch.Tensor, n_tokens: int, slot: int,
                    start: int, cache: SlotCache, cfg: LlamaConfig,
                    prefix_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> Tuple[torch.Tensor, SlotCache]:
    """Prefill a chunk into ONE slot at position ``start``, attending over
    the slot's already-cached [0, start) prefix: the prefix-cache admit
    path. RoPE positions continue at ``start``. Returns the slot's
    next-token logits [1, V] and the cache.

    Each layer writes the chunk at [start, start+N) and attends over the
    slot's row with the combined prefix + causal mask
    ``col <= start + row  AND  col < start + n``. ``prefix_kv``, if given,
    is a pinned shared-prefix KV installed into rows [0, P) first."""
    N = input_ids.shape[1]
    S = cache.k.shape[3]
    if start + N > S:
        raise ValueError(f"slot_prefill_at: {start} + {N} overflows the "
                         f"cache of {S}")
    if prefix_kv is not None:
        install_prefix(prefix_kv, slot, cache)
    dev = input_ids.device
    x = L.embed(params["embed_tokens"], input_ids)
    positions = start + torch.arange(N, device=dev)[None, :]
    # columns at or past start + N are masked for every row: leave them out
    end = start + N
    col = torch.arange(end, device=dev)[None, :]
    row = torch.arange(N, device=dev)[:, None]
    mask = ((col <= start + row) & (col < start + n_tokens))[None, None]
    for i, lp in enumerate(params["layers"]):
        q, kk, vv = _attn_qkv(lp, x, positions, cfg)
        _slot_write(cache, i, slot, start, kk, vv)
        o = _cached_attn(q, cache.k[i, slot:slot + 1, :, :end],
                         cache.v[i, slot:slot + 1, :, :end], mask)
        x = _attn_out_mlp(lp, x, o, cfg)
    cache.length[slot] = start + n_tokens
    return _last_logits(params, x, n_tokens, cfg), cache


def install_and_prefill_at(params, prefix_kv, input_ids: torch.Tensor,
                           n_tokens: int, slot: int, start: int,
                           cache: SlotCache, cfg: LlamaConfig
                           ) -> Tuple[torch.Tensor, SlotCache]:
    """Prefix install folded into the remainder's prefill: the prefix-hit
    admit, one call."""
    return slot_prefill_at(params, input_ids, n_tokens, slot, start, cache,
                           cfg, prefix_kv=prefix_kv)


def slot_decode(params, input_ids: torch.Tensor, active: torch.Tensor,
                cache: SlotCache, cfg: LlamaConfig
                ) -> Tuple[torch.Tensor, SlotCache]:
    """One decode step for ALL slots; ``active`` [B] bool gates cache writes
    and length increments for occupied slots. ids [B, 1] -> logits [B, V].
    An inactive slot's row and length are left as they were."""
    B = input_ids.shape[0]
    S = cache.k.shape[3]
    dev = input_ids.device
    x = L.embed(params["embed_tokens"], input_ids)
    length = cache.length
    positions = length[:, None]
    col = torch.arange(S, device=dev)
    mask = (col[None, :] <= length[:, None])[:, None, None, :]    # [B,1,1,S]
    rows = torch.arange(B, device=dev)
    pos = length.clamp(0, S - 1)
    keep = active[:, None, None]
    for i, lp in enumerate(params["layers"]):
        q, kk, vv = _attn_qkv(lp, x, positions, cfg)
        # each row's k, v at its own write position; an inactive row's
        # clipped cursor only touches that row, which gets its old value
        for c, new in ((cache.k, kk), (cache.v, vv)):
            layer = _raw(c)[i]                                    # [B,H,S,D]
            cur = _raw(_cache_cast(new[:, 0], c.dtype))           # [B,H,D]
            layer[rows, :, pos] = torch.where(keep, cur, layer[rows, :, pos])
        o = _cached_attn(q, cache.k[i], cache.v[i], mask)
        x = _attn_out_mlp(lp, x, o, cfg)
    logits = _logits(params, x, cfg)[:, 0]
    cache.length = torch.where(active, length + 1, length)
    return logits, cache


def slot_decode_sample(params, input_ids: torch.Tensor, active: torch.Tensor,
                       temperature: torch.Tensor, top_p: torch.Tensor,
                       greedy: torch.Tensor, cache: SlotCache,
                       keys: torch.Tensor, ctr: torch.Tensor,
                       cfg: LlamaConfig, top_k: int = 0
                       ) -> Tuple[torch.Tensor, SlotCache]:
    """Decode + per-slot sampling, all on the device: ids [B, 1] -> next
    tokens [B].

    ``keys`` [B, 2] is a PER-REQUEST key per slot and ``ctr`` [B] the
    request's sampled-token counter: row b samples with
    fold_in(keys[b], ctr[b]). A request's stream therefore depends only on
    its own (key, position): seeded requests reproduce exactly under ANY
    concurrent mix."""
    logits, cache = slot_decode(params, input_ids, active, cache, cfg)
    tok = sample_batched(fold_in(keys, ctr), logits, temperature, top_p,
                         greedy, top_k)
    return tok, cache


def slot_decode_sample_steps(params, tok0: torch.Tensor, active: torch.Tensor,
                             temperature: torch.Tensor, top_p: torch.Tensor,
                             greedy: torch.Tensor, cache: SlotCache,
                             keys: torch.Tensor, ctr0: torch.Tensor,
                             cfg: LlamaConfig, steps: int = 8, top_k: int = 0
                             ) -> Tuple[torch.Tensor, SlotCache]:
    """Multi-step scheduling: ``steps`` decode + sample iterations with no
    host round trip between them. The host truncates each slot's stream at
    eos/budget afterwards; tokens a slot sampled past its own finish land
    only in THAT slot's cache rows, which the next admit's prefill re-masks
    (the mask is ``col <= length`` and prefill resets the length), so they
    are harmless by construction. Step t samples row b with
    fold_in(keys[b], ctr0[b] + t): identical tokens to ``steps``
    single-step calls. tok0 [B] -> tokens [steps, B]."""
    tok, toks = tok0, []
    for t in range(steps):
        tok, cache = slot_decode_sample(params, tok[:, None], active,
                                        temperature, top_p, greedy, cache,
                                        keys, ctr0 + t, cfg, top_k)
        toks.append(tok)
    return torch.stack(toks, dim=0), cache
