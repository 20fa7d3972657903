"""Operations and bytes of the work the benchmark's cells drive, computed
from shapes. Part of the yardstick: the per-layer readers take their
numerators from here, never from the program.

Each input byte is counted once and each output byte once, whatever a
kernel reads again; operations are those the model needs (padding of a
prompt bucket, and work on inactive decode slots, are not counted).
"""
from __future__ import annotations

from typing import Iterable, Tuple

from .peaks import BF16_FLOPS, HBM_BYTES_PER_S


# ------------------------------ LLaMA ---------------------------------------

def llama_linears(spec) -> list:
    """(K, N) of one decoder layer's seven projections."""
    d, f = spec.dim, spec.ffn_dim
    kv = spec.kv_heads * (d // spec.heads)
    return [(d, d), (d, kv), (d, kv), (d, d), (d, f), (d, f), (f, d)]


def llama_layer_params(spec) -> int:
    return sum(k * n for k, n in llama_linears(spec))


def llama_attn_flops(spec, ctx: int) -> float:
    """Q K^T and P V of one token over ``ctx`` cached positions, all layers."""
    return 4.0 * ctx * spec.dim * spec.layers


def llama_prefill_flops(spec, start: int, n: int) -> float:
    """Model operations of ``n`` real prompt tokens written at ``start``: the
    projections, causal attention over [0, p] for the token at p, and the
    lm_head on the chunk's last token (the only row a slot prefill
    projects)."""
    proj = 2.0 * n * spec.layers * llama_layer_params(spec)
    # sum over p in [start, start + n) of (p + 1) attended positions
    attended = n * start + n * (n + 1) / 2.0
    return proj + llama_attn_flops(spec, 1) * attended \
        + 2.0 * spec.dim * spec.vocab


def llama_weight_bytes(spec) -> float:
    """Stored weights a decode step reads once: int8 codes and fp32 scales of
    every layer and of the lm_head, bf16 norms."""
    lin = spec.layers * llama_layer_params(spec) + spec.dim * spec.vocab
    scales = 4.0 * (spec.layers * sum(n for _, n in llama_linears(spec))
                    + spec.vocab)
    norms = 2.0 * spec.dim * (2 * spec.layers + 1)
    return lin + scales + norms


def llama_decode_work(spec, ctx_lens: Iterable[int], cache_bytes: int
                      ) -> Tuple[float, float]:
    """(operations, compulsory bytes) of one decode step over the live slots,
    slot i holding ``ctx_lens[i]`` cached tokens: the weights read once, each
    live slot's cache rows read once, its new k and v written once, and its
    embedding row and logits."""
    kv_row = 2.0 * spec.layers * spec.kv_heads * (spec.dim // spec.heads) \
        * cache_bytes
    flops, nbytes = 0.0, llama_weight_bytes(spec)
    per_tok = 2.0 * (spec.layers * llama_layer_params(spec)
                     + spec.dim * spec.vocab)
    for c in ctx_lens:
        flops += per_tok + llama_attn_flops(spec, c + 1)
        nbytes += kv_row * (c + 1) + 2.0 * spec.dim + 4.0 * spec.vocab
    return flops, nbytes


def int8_linear_work(m: int, k: int, n: int) -> Tuple[float, float]:
    """x [M, K] bf16 @ w [K, N] int8 * scale [N] fp32 -> y [M, N] bf16:
    2 M N K operations; x, the int8 weight, the scale and y once each (as
    ``chip_smoke.py`` counts row 2)."""
    return 2.0 * m * n * k, 2.0 * m * k + 1.0 * k * n + 4.0 * n + 2.0 * m * n


def bound_s(flops: float, nbytes: float, peak_flops: float = BF16_FLOPS
            ) -> float:
    return max(flops / peak_flops, nbytes / HBM_BYTES_PER_S)


# --------------------------- SEED-2 tokenizer -------------------------------

def seed_encode_flops(spec) -> float:
    """Operations of one image's encode: EVA-ViT (patch embedding, blocks),
    the causal Q-Former (self-attention, cross-attention every
    ``cross_freq`` layers, FFN), encode_task and the VQ distances."""
    v, q = spec["vit"], spec["qformer"]
    n = (v["image_size"] // v["patch_size"]) ** 2 + 1
    d, m = v["dim"], v["mlp_dim"]
    patch_in = v["patch_size"] ** 2 * 3
    vit = 2.0 * (n - 1) * patch_in * d
    vit += v["depth"] * (2.0 * n * (3 * d * d + d * d + 2 * d * m)
                         + 4.0 * n * n * d)
    h, t, w = q["hidden"], q["query_len"], q["encoder_width"]
    qf = 0.0
    for i in range(q["layers"]):
        qf += 2.0 * t * 4 * h * h + 4.0 * t * t * h
        if i % q["cross_freq"] == 0:
            qf += 2.0 * t * 2 * h * h + 2.0 * n * 2 * w * h + 4.0 * t * n * h
        qf += 2.0 * t * 2 * h * q["intermediate"]
    task = 2.0 * t * (h * h + h * spec["code_dim"])
    vq = 2.0 * t * spec["codebook_size"] * spec["code_dim"]
    return vit + qf + task + vq
