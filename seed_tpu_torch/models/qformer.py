"""Causal Q-Former (counterpart of seed_tpu/models/qformer.py).

32 learned queries attend causally among themselves, cross-attend to the
ViT features every ``cross_freq`` layers, and use the query FFN; post-norm
residuals, LayerNorm eps 1e-12, erf GELU. With ``with_text`` (stage-1
training) the tree also holds the BERT word and position embeddings and a
text FFN per layer, for three more forwards: the joint query + text pass of
ITM (``qformer_apply(text_ids=...)``), the text encoder
(``qformer_text_apply``) and the decoder-mode caption pass
(``qformer_caption_apply``) with its tied LM head, and greedy caption
generation through it: recomputing the joint forward at every position
(``qformer_generate_caption``) or over a bank of the queries' keys and
values (``qformer_generate_caption_cached``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..ops.attention import mha
from . import layers as L


@dataclass(frozen=True)
class QFormerConfig:
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    encoder_width: int = 1408     # ViT feature dim for cross-attention
    cross_freq: int = 2
    query_len: int = 32
    vocab_size: int = 30523       # bert-base-uncased + [DEC] (blip2.py:37-39)
    max_position: int = 512
    ln_eps: float = 1e-12
    with_text: bool = False       # stage-1 training keeps the text pathway

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


SEED_QFORMER = QFormerConfig()
TINY_QFORMER = QFormerConfig(hidden=32, layers=4, heads=2, intermediate=64,
                             encoder_width=48, query_len=8, vocab_size=64,
                             max_position=64)


# ------------------------------ init --------------------------------------

def _init_attn(gen, q_in: int, kv_in: int, hidden: int, dtype, device):
    return {
        "q": L.init_linear(gen, q_in, hidden, dtype=dtype, device=device),
        "k": L.init_linear(gen, kv_in, hidden, dtype=dtype, device=device),
        "v": L.init_linear(gen, kv_in, hidden, dtype=dtype, device=device),
        "out": L.init_linear(gen, hidden, hidden, dtype=dtype, device=device),
        "norm": L.init_layer_norm(hidden, dtype, device),
    }


def _init_ffn(gen, hidden: int, intermediate: int, dtype, device):
    return {
        "fc1": L.init_linear(gen, hidden, intermediate, dtype=dtype, device=device),
        "fc2": L.init_linear(gen, intermediate, hidden, dtype=dtype, device=device),
        "norm": L.init_layer_norm(hidden, dtype, device),
    }


def init_qformer(gen, cfg: QFormerConfig, dtype=torch.float32, device="cuda"):
    layers = []
    for i in range(cfg.layers):
        layer = {
            "self": _init_attn(gen, cfg.hidden, cfg.hidden, cfg.hidden, dtype, device),
            "ffn_q": _init_ffn(gen, cfg.hidden, cfg.intermediate, dtype, device),
        }
        if i % cfg.cross_freq == 0:
            layer["cross"] = _init_attn(gen, cfg.hidden, cfg.encoder_width,
                                        cfg.hidden, dtype, device)
        if cfg.with_text:
            layer["ffn_t"] = _init_ffn(gen, cfg.hidden, cfg.intermediate,
                                       dtype, device)
        layers.append(layer)
    params = {
        "query_tokens": L.normal(gen, (1, cfg.query_len, cfg.hidden), 0.02,
                                 dtype, device),
        "embeddings": {"norm": L.init_layer_norm(cfg.hidden, dtype, device)},
        "layers": layers,
    }
    if cfg.with_text:
        emb = params["embeddings"]
        emb["word_embeddings"] = L.init_embed(gen, cfg.vocab_size, cfg.hidden,
                                              dtype, device=device)
        emb["position_embeddings"] = L.init_embed(
            gen, cfg.max_position, cfg.hidden, dtype, device=device)
    return params


# ----------------------------- masking ------------------------------------

def _grid(n: int, device):
    return (torch.arange(n, device=device)[:, None],
            torch.arange(n, device=device)[None, :])


def _key_pad(mask: torch.Tensor, query_len: int,
             text_pad: torch.Tensor) -> torch.Tensor:
    """``mask`` & no attention to padded text keys: [B, 1, Q+T, Q+T]."""
    keys = torch.cat([torch.ones((text_pad.shape[0], query_len), dtype=torch.bool,
                                 device=text_pad.device), text_pad.bool()], 1)
    return mask & keys[:, None, None, :]


def seed_causal_mask(query_len: int, text_len: int = 0,
                     text_pad: Optional[torch.Tensor] = None,
                     device=None) -> torch.Tensor:
    """The SEED query-causal mask (qformer_causual.py:698-714) over the
    layout [Q | T]: queries attend causally to earlier queries and fully to
    the text; text attends to everything (except padded text keys). Bool
    [1, 1, Q+T, Q+T], or [B, 1, Q+T, Q+T] when ``text_pad`` is given."""
    row, col = _grid(query_len + text_len, device)
    in_query_block = (row < query_len) & (col < query_len)
    mask = torch.where(in_query_block, col <= row,
                       torch.ones_like(in_query_block))[None, None]
    if text_pad is not None and text_len > 0:
        mask = _key_pad(mask, query_len, text_pad)
    return mask


def seed_caption_mask(query_len: int, text_len: int,
                      device=None) -> torch.Tensor:
    """UniLM-style decoder mask (qformer_causual.py:723-748): queries attend
    causally among themselves but not to the text; text attends to every
    query and causally to itself. Bool [1, 1, Q+T, Q+T]."""
    row, col = _grid(query_len + text_len, device)
    query_row_text_col = (row < query_len) & (col >= query_len)
    return ((col <= row) & ~query_row_text_col)[None, None]


# ----------------------------- forward ------------------------------------

def _attn_apply(p, x_q, x_kv, cfg: QFormerConfig, mask=None):
    B, N, _ = x_q.shape
    M = x_kv.shape[1]
    H, hd = cfg.heads, cfg.head_dim
    q = L.linear(p["q"], x_q).reshape(B, N, H, hd)
    k = L.linear(p["k"], x_kv).reshape(B, M, H, hd)
    v = L.linear(p["v"], x_kv).reshape(B, M, H, hd)
    o = mha(q, k, v, mask=mask).reshape(B, N, cfg.hidden)
    # BertSelfOutput: dense -> residual -> LN (post-norm)
    return L.layer_norm(p["norm"], x_q + L.linear(p["out"], o), cfg.ln_eps)


def _ffn_apply(p, x, cfg: QFormerConfig):
    h = L.linear(p["fc2"], L.gelu(L.linear(p["fc1"], x)))
    return L.layer_norm(p["norm"], x + h, cfg.ln_eps)


def _text_embed(emb, text_ids: torch.Tensor) -> torch.Tensor:
    tok = L.embed(emb["word_embeddings"], text_ids)
    pos = emb["position_embeddings"]["embedding"][:text_ids.shape[1]]
    return tok + pos.to(tok.dtype)


def _layers_apply(params, x, image_embeds, cfg: QFormerConfig, mask,
                  text_len: int):
    """The layer stack over [Q | T]: self-attention over all, cross-attention
    and the query FFN on the queries (BertLayer :393-406), the text FFN on
    the text."""
    Q = cfg.query_len
    for layer in params["layers"]:
        x = _attn_apply(layer["self"], x, x, cfg, mask=mask)
        if "cross" in layer:
            xq = _attn_apply(layer["cross"], x[:, :Q], image_embeds, cfg)
            x = torch.cat([xq, x[:, Q:]], 1) if text_len else xq
        xq = _ffn_apply(layer["ffn_q"], x[:, :Q], cfg)
        x = (torch.cat([xq, _ffn_apply(layer["ffn_t"], x[:, Q:], cfg)], 1)
             if text_len else xq)
    return x


def qformer_apply(params, image_embeds: torch.Tensor, cfg: QFormerConfig,
                  text_ids: Optional[torch.Tensor] = None,
                  text_pad: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Query(+text) forward: image_embeds [B, M, encoder_width] ->
    [B, Q(+T), hidden] (Qformer.bert(query_embeds=...,
    encoder_hidden_states=...), qformer_causual.py:768-915, is_casual=True).
    With ``text_ids`` [B, T] (and ``text_pad``, 1 = real token) the text
    follows the queries under ``seed_causal_mask``: ITM's joint pass."""
    B = image_embeds.shape[0]
    Q = cfg.query_len
    x = params["query_tokens"].to(image_embeds.dtype).expand(B, Q, cfg.hidden)
    T = 0
    if text_ids is not None:
        T = text_ids.shape[1]
        x = torch.cat([x, _text_embed(params["embeddings"], text_ids)
                       .to(x.dtype)], 1)
    x = L.layer_norm(params["embeddings"]["norm"], x, cfg.ln_eps)
    mask = seed_causal_mask(Q, T, text_pad, image_embeds.device)
    return _layers_apply(params, x, image_embeds, cfg, mask, T)


def qformer_caption_apply(params, image_embeds: torch.Tensor,
                          text_ids: torch.Tensor, cfg: QFormerConfig,
                          text_pad: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Decoder-mode forward of the stage-1 captioning loss
    (blip2_qformer_casual.py:275-296, BertLMHeadModel): queries as a visual
    prefix, text left to right under ``seed_caption_mask``. Returns the text
    hidden states [B, T, hidden]."""
    B = image_embeds.shape[0]
    Q, T = cfg.query_len, text_ids.shape[1]
    tok = _text_embed(params["embeddings"], text_ids)
    x_q = params["query_tokens"].to(tok.dtype).expand(B, Q, cfg.hidden)
    x = L.layer_norm(params["embeddings"]["norm"], torch.cat([x_q, tok], 1),
                     cfg.ln_eps)
    mask = seed_caption_mask(Q, T, image_embeds.device)
    if text_pad is not None:
        mask = _key_pad(mask, Q, text_pad)
    return _layers_apply(params, x, image_embeds, cfg, mask, T)[:, Q:]


@torch.no_grad()
def qformer_generate_caption(params, lm_head, image_embeds: torch.Tensor,
                             cfg: QFormerConfig, bos_id: int, eos_id: int,
                             max_len: int = 24) -> torch.Tensor:
    """Greedy caption generation through the decoder-mode Q-Former
    (BertLMHeadModel.generate, qformer_causual.py:933-1062), recomputing the
    joint forward at each position with the text after it masked as padding.
    Once a row emits eos it keeps emitting eos. Returns int32 [B, max_len]
    (bos, then the generated ids)."""
    B = image_embeds.shape[0]
    dev = image_embeds.device
    tokens = torch.full((B, max_len), eos_id, dtype=torch.int32, device=dev)
    tokens[:, 0] = bos_id
    pos = torch.arange(max_len, device=dev)[None]
    word = params["embeddings"]["word_embeddings"]
    for i in range(max_len - 1):
        pad = (pos <= i).to(torch.int32).expand(B, max_len)
        hidden = qformer_caption_apply(params, image_embeds, tokens, cfg,
                                       text_pad=pad)
        logits = lm_head_apply(lm_head, word, hidden[:, i], cfg)
        nxt = logits.argmax(-1).to(torch.int32)
        tokens[:, i + 1] = torch.where(tokens[:, i] == eos_id, eos_id, nxt)
    return tokens


@torch.no_grad()
def qformer_caption_prefix(params, image_embeds: torch.Tensor,
                           cfg: QFormerConfig, max_text: int):
    """KV-cached caption generation, phase 1: the visual prefix.

    Under the caption mask (``seed_caption_mask``) the queries never attend
    to the text, so their hidden states, and each layer's self-attention
    K/V of them, do not depend on the generated text. The query block runs
    once (the first Q rows of ``qformer_caption_apply``) and each layer's
    K/V is banked (BertLMHeadModel.generate's past_key_values).

    Returns a list per layer of {"k", "v"} [B, Q + max_text, H, hd] with
    rows [:Q] filled; ``qformer_caption_step`` writes the text rows."""
    B = image_embeds.shape[0]
    Q, H, hd = cfg.query_len, cfg.heads, cfg.head_dim
    x = params["query_tokens"].to(image_embeds.dtype).expand(B, Q, cfg.hidden)
    x = L.layer_norm(params["embeddings"]["norm"], x, cfg.ln_eps)
    qmask = seed_causal_mask(Q, device=image_embeds.device)
    cache = []
    for layer in params["layers"]:
        p = layer["self"]
        k = L.linear(p["k"], x).reshape(B, Q, H, hd)
        v = L.linear(p["v"], x).reshape(B, Q, H, hd)
        bank = {n: x.new_zeros((B, Q + max_text, H, hd)) for n in ("k", "v")}
        bank["k"][:, :Q] = k
        bank["v"][:, :Q] = v
        cache.append(bank)
        q = L.linear(p["q"], x).reshape(B, Q, H, hd)
        o = mha(q, k, v, mask=qmask).reshape(B, Q, cfg.hidden)
        x = L.layer_norm(p["norm"], x + L.linear(p["out"], o), cfg.ln_eps)
        if "cross" in layer:
            x = _attn_apply(layer["cross"], x, image_embeds, cfg)
        x = _ffn_apply(layer["ffn_q"], x, cfg)
    return cache


@torch.no_grad()
def qformer_caption_step(params, cache, tok: torch.Tensor, i: int,
                         cfg: QFormerConfig):
    """KV-cached caption decode, phase 2: one text token ``tok`` [B] at text
    position ``i``. Writes its K/V into row Q + i of the bank (in place) and
    returns (hidden [B, hidden], cache). Text rows have no cross-attention
    and take the text FFN (rows [Q:] of ``qformer_caption_apply``)."""
    B = tok.shape[0]
    Q, H, hd = cfg.query_len, cfg.heads, cfg.head_dim
    S = cache[0]["k"].shape[1]
    emb = params["embeddings"]
    x = (L.embed(emb["word_embeddings"], tok[:, None])
         + emb["position_embeddings"]["embedding"][i][None, None])
    x = L.layer_norm(emb["norm"], x, cfg.ln_eps)                # [B, 1, hidden]
    # visible: every query and the text rows up to i
    visible = (torch.arange(S, device=tok.device) < Q + i + 1)[None, None, None]
    for layer, bank in zip(params["layers"], cache):
        p = layer["self"]
        bank["k"][:, Q + i] = L.linear(p["k"], x).reshape(B, H, hd)
        bank["v"][:, Q + i] = L.linear(p["v"], x).reshape(B, H, hd)
        q = L.linear(p["q"], x).reshape(B, 1, H, hd)
        o = mha(q, bank["k"], bank["v"], mask=visible).reshape(B, 1, cfg.hidden)
        x = L.layer_norm(p["norm"], x + L.linear(p["out"], o), cfg.ln_eps)
        x = _ffn_apply(layer["ffn_t"], x, cfg)
    return x[:, 0], cache


@torch.no_grad()
def qformer_generate_caption_cached(params, lm_head,
                                    image_embeds: torch.Tensor,
                                    cfg: QFormerConfig, bos_id: int,
                                    eos_id: int, max_len: int = 24
                                    ) -> torch.Tensor:
    """Greedy caption generation over the banked prefix: the tokens of
    ``qformer_generate_caption`` (the same greedy math) at one position per
    step instead of Q + T. Returns int32 [B, max_len]."""
    B = image_embeds.shape[0]
    cache = qformer_caption_prefix(params, image_embeds, cfg, max_len)
    word = params["embeddings"]["word_embeddings"]
    tokens = torch.full((B, max_len), eos_id, dtype=torch.int32,
                        device=image_embeds.device)
    tokens[:, 0] = bos_id
    for i in range(max_len - 1):
        hidden, cache = qformer_caption_step(params, cache, tokens[:, i], i,
                                             cfg)
        nxt = lm_head_apply(lm_head, word, hidden, cfg).argmax(-1)
        tokens[:, i + 1] = torch.where(tokens[:, i] == eos_id, eos_id,
                                       nxt.to(torch.int32))
    return tokens


def qformer_text_apply(params, text_ids: torch.Tensor, cfg: QFormerConfig,
                       text_pad: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Text-only BERT forward (stage-1 text encoding,
    blip2_qformer_casual.py:152-158): bidirectional self-attention with the
    padding mask, text FFN, no cross-attention. [B, T, hidden], CLS at 0."""
    x = L.layer_norm(params["embeddings"]["norm"],
                     _text_embed(params["embeddings"], text_ids), cfg.ln_eps)
    mask = None if text_pad is None else text_pad.bool()[:, None, None, :]
    for layer in params["layers"]:
        x = _attn_apply(layer["self"], x, x, cfg, mask=mask)
        x = _ffn_apply(layer["ffn_t"], x, cfg)
    return x


def init_lm_head(gen, cfg: QFormerConfig, dtype=torch.float32, device="cuda"):
    """BERT LM head: transform (dense + gelu + LN), then a decoder tied to
    the word embeddings plus a free bias (BertLMHeadModel cls)."""
    return {"transform": L.init_linear(gen, cfg.hidden, cfg.hidden,
                                       dtype=dtype, device=device),
            "norm": L.init_layer_norm(cfg.hidden, dtype, device),
            "bias": torch.zeros((cfg.vocab_size,), dtype=dtype, device=device)}


def lm_head_apply(head, word_embeddings, hidden: torch.Tensor,
                  cfg: QFormerConfig) -> torch.Tensor:
    h = L.gelu(L.linear(head["transform"], hidden))
    h = L.layer_norm(head["norm"], h, cfg.ln_eps)
    logits = h @ word_embeddings["embedding"].to(h.dtype).T
    return logits + head["bias"].to(logits.dtype)
