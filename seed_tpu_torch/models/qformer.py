"""Causal Q-Former, query path (counterpart of seed_tpu/models/qformer.py).

32 learned queries attend causally among themselves, cross-attend to the
ViT features every ``cross_freq`` layers, and use the query FFN; post-norm
residuals, LayerNorm eps 1e-12, erf GELU. The text and caption paths of
stage-1 training are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass

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
    ln_eps: float = 1e-12

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


SEED_QFORMER = QFormerConfig()


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
        layers.append(layer)
    return {
        "query_tokens": L.normal(gen, (1, cfg.query_len, cfg.hidden), 0.02,
                                 dtype, device),
        "embeddings": {"norm": L.init_layer_norm(cfg.hidden, dtype, device)},
        "layers": layers,
    }


# ----------------------------- masking ------------------------------------

def seed_causal_mask(query_len: int, device=None) -> torch.Tensor:
    """The SEED query-causal mask (qformer_causual.py:698-714) over the query
    block: bool [1, 1, Q, Q], query i attends to queries j <= i."""
    row = torch.arange(query_len, device=device)[:, None]
    col = torch.arange(query_len, device=device)[None, :]
    return (col <= row)[None, None]


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


def qformer_apply(params, image_embeds: torch.Tensor,
                  cfg: QFormerConfig) -> torch.Tensor:
    """Query forward: image_embeds [B, M, encoder_width] -> [B, Q, hidden]
    (Qformer.bert(query_embeds=..., encoder_hidden_states=...),
    qformer_causual.py:768-915, is_casual=True, no text)."""
    B = image_embeds.shape[0]
    Q = cfg.query_len
    x = params["query_tokens"].to(image_embeds.dtype).expand(B, Q, cfg.hidden)
    x = L.layer_norm(params["embeddings"]["norm"], x, cfg.ln_eps)
    self_mask = seed_causal_mask(Q, image_embeds.device)
    for layer in params["layers"]:
        x = _attn_apply(layer["self"], x, x, cfg, mask=self_mask)
        if "cross" in layer:
            x = _attn_apply(layer["cross"], x, image_embeds, cfg)
        x = _ffn_apply(layer["ffn_q"], x, cfg)
    return x
