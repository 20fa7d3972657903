"""Operations and bytes of the de-tokenizer's work (kind ``unclip``),
computed from the configuration's sizes. Part of the yardstick, as
``core/work.py``: the readers take their numerators from here, never from
the program.

Operations are those of the weight products, convolutions and attention
products (2 a multiply-add); norms, activations and the DDIM arithmetic are
left out, as a FLOP counter leaves them out.
"""
from __future__ import annotations

from typing import List, Tuple

from .work import bound_s

BF16 = 2


def _conv(b: int, side: int, cin: int, cout: int, k: int = 3) -> float:
    """A k x k convolution with ``side`` x ``side`` outputs."""
    return 2.0 * b * side * side * cin * cout * k * k


def _resnet(b: int, side: int, cin: int, cout: int, temb: int = 0) -> float:
    f = _conv(b, side, cin, cout) + _conv(b, side, cout, cout)
    if cin != cout:
        f += _conv(b, side, cin, cout, 1)
    return f + 2.0 * b * temb * cout


def self_attention_work(b: int, n: int, c: int) -> Tuple[float, float]:
    """(operations, compulsory bytes) of one ``self_attention`` span of
    ``b`` sequences of ``n`` tokens, ``c`` wide: the four projections and
    4 b n^2 c of Q K^T and P V; its input, the four weights, the output
    bias and its output once each, in bf16."""
    flops = 8.0 * b * n * c * c + 4.0 * b * n * n * c
    nbytes = BF16 * (2.0 * b * n * c + 4.0 * c * c + c)
    return flops, nbytes


def _transformer(b: int, n: int, c: int, m: int, kv: int) -> float:
    """A linear-projection ``Transformer2DModel`` with one block: proj in /
    out, self-attention, cross-attention to ``m`` tokens of width ``kv``,
    the GEGLU feed-forward (8c, then 4c back)."""
    proj = 4.0 * b * n * c * c
    attn1 = self_attention_work(b, n, c)[0]
    attn2 = 4.0 * b * n * c * c + 4.0 * b * m * kv * c + 4.0 * b * n * m * c
    ff = 2.0 * b * n * c * 8 * c + 2.0 * b * n * 4 * c * c
    return proj + attn1 + attn2 + ff


def _levels(spec) -> Tuple[list, list, int]:
    u = spec["unet"]
    cross = [t.startswith("CrossAttn") for t in u["down_block_types"]]
    return u["block_out_channels"], cross, u["sample_size"]


def self_attention_shapes(spec, b: int) -> List[Tuple[int, int, int]]:
    """(b, tokens, width) of every self-attention of one UNet pass at batch
    ``b``: each level's down layers, the middle block, each level's up
    layers."""
    C, cross, side = _levels(spec)
    L = spec["unet"]["layers_per_block"]
    out = []
    for i, c in enumerate(C):
        if cross[i]:
            out += [(b, (side >> i) ** 2, c)] * L
    out.append((b, (side >> (len(C) - 1)) ** 2, C[-1]))
    for i, c in reversed(list(enumerate(C))):
        if cross[i]:
            out += [(b, (side >> i) ** 2, c)] * (L + 1)
    return out


def unet_flops(spec, b: int) -> float:
    """One UNet pass at batch ``b`` (the CFG batch: twice the images)."""
    u = spec["unet"]
    C, cross, side = _levels(spec)
    L, temb = u["layers_per_block"], 4 * C[0]
    m = spec["text_encoder"]["max_position_embeddings"]
    kv = u["cross_attention_dim"]
    f = 2.0 * b * (C[0] * temb + temb * temb)
    f += 2.0 * b * (u["projection_class_embeddings_input_dim"] * temb
                    + temb * temb)
    f += _conv(b, side, u["in_channels"], C[0])
    skips = [C[0]]
    cin = C[0]
    for i, c in enumerate(C):
        s = side >> i
        for _ in range(L):
            f += _resnet(b, s, cin, c, temb)
            if cross[i]:
                f += _transformer(b, s * s, c, m, kv)
            cin = c
            skips.append(c)
        if i < len(C) - 1:
            f += _conv(b, s // 2, c, c)
            skips.append(c)
    s = side >> (len(C) - 1)
    f += 2 * _resnet(b, s, C[-1], C[-1], temb)
    f += _transformer(b, s * s, C[-1], m, kv)
    for i in reversed(range(len(C))):
        c, s = C[i], side >> i
        for _ in range(L + 1):
            f += _resnet(b, s, cin + skips.pop(), c, temb)
            if cross[i]:
                f += _transformer(b, s * s, c, m, kv)
            cin = c
        if i > 0:
            f += _conv(b, 2 * s, c, c)
    return f + _conv(b, side, C[0], u["out_channels"])


def vae_flops(spec, b: int) -> float:
    """The AutoencoderKL decoder at batch ``b``, from the latents."""
    v = spec["vae"]
    C = list(reversed(v["block_out_channels"]))
    s = spec["unet"]["sample_size"]
    lat = v["latent_channels"]
    f = _conv(b, s, lat, lat, 1) + _conv(b, s, lat, C[0])
    f += 2 * _resnet(b, s, C[0], C[0])
    n = s * s
    f += 8.0 * b * n * C[0] * C[0] + 4.0 * b * n * n * C[0]
    cin = C[0]
    for i, c in enumerate(C):
        for _ in range(v["layers_per_block"] + 1):
            f += _resnet(b, s, cin, c)
            cin = c
        if i < len(C) - 1:
            s *= 2
            f += _conv(b, s, c, c)
    return f + _conv(b, s, C[-1], v["out_channels"])


def decode_embedding_flops(spec, b: int) -> float:
    """The tokenizer's decode half: codes -> unCLIP embedding."""
    t = spec["tokenizer"]
    q, d, h = t["query_len"], t["code_dim"], t["hidden"]
    f = 2.0 * b * q * (d * d + d * h)
    f += t["decode_depth"] * (2.0 * b * q * (4 * h * h + 8 * h * h)
                              + 4.0 * b * q * q * h)
    f += 2.0 * b * q * (h * 256 + 256 * 128 + 128 * 32)
    return f + 2.0 * b * q * 32 * t["image_embed_dim"]


def detok_flops(spec) -> float:
    """One image's de-tokenize: the decode half, each step's UNet pass over
    the CFG batch of two, the VAE."""
    steps = spec["pipeline"]["num_inference_steps"]
    return (decode_embedding_flops(spec, 1) + steps * unet_flops(spec, 2)
            + vae_flops(spec, 1))


def unet_self_attention_bound_s(spec, b: int) -> float:
    """Least time of one UNet pass's self-attention spans at batch ``b``,
    each bounded apart by its operations at the bf16 peak or its bytes at
    the HBM rate, whichever is longer."""
    return sum(bound_s(*self_attention_work(*shape))
               for shape in self_attention_shapes(spec, b))
