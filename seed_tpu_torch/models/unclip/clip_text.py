"""CLIP text encoder (OpenCLIP ViT-H text tower) of the unCLIP pipeline
(counterpart of seed_tpu/models/unclip/clip_text.py).

The de-tokenizer conditions on the empty prompt only: the pipeline reads its
output once, cached as ``params["empty_prompt_embeds"]`` (the converter's
entry point computes it from a converted text tower). The tower is here so
that the package is whole and a converted tower can be run.

Arch (stable-diffusion-2-1 text_encoder): vocab 49408, hidden 1024, 23
layers kept (SD2 uses the penultimate layer of the 24-layer tower), 16
heads, mlp 4096, causal mask, final LayerNorm, exact GELU.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ... import resolve_device
from ...ops.attention import causal_mask, mha
from .. import layers as L


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden: int = 1024
    layers: int = 23
    heads: int = 16
    mlp_dim: int = 4096
    max_len: int = 77
    ln_eps: float = 1e-5


SD21_TEXT = CLIPTextConfig()
TINY_TEXT = CLIPTextConfig(vocab_size=64, hidden=16, layers=2, heads=2,
                           mlp_dim=32, max_len=8)


@torch.no_grad()
def init_clip_text(gen: torch.Generator, cfg: CLIPTextConfig = SD21_TEXT,
                   dtype=torch.float32, device="cuda"):
    """Seeded random text-tower weights on ``device`` (the card by default)."""
    device = resolve_device(device)
    lin = lambda i, o: L.init_linear(gen, i, o, dtype=dtype, device=device)
    ln = lambda: L.init_layer_norm(cfg.hidden, dtype, device)
    layers = [{"ln1": ln(),
               "q": lin(cfg.hidden, cfg.hidden), "k": lin(cfg.hidden, cfg.hidden),
               "v": lin(cfg.hidden, cfg.hidden),
               "out": lin(cfg.hidden, cfg.hidden),
               "ln2": ln(),
               "fc1": lin(cfg.hidden, cfg.mlp_dim),
               "fc2": lin(cfg.mlp_dim, cfg.hidden)}
              for _ in range(cfg.layers)]
    return {
        "token_embedding": L.init_embed(gen, cfg.vocab_size, cfg.hidden, dtype,
                                        device=device),
        "position_embedding": L.init_embed(gen, cfg.max_len, cfg.hidden, dtype,
                                           device=device),
        "layers": layers,
        "final_ln": ln(),
    }


def clip_text_apply(params, ids: torch.Tensor,
                    cfg: CLIPTextConfig = SD21_TEXT) -> torch.Tensor:
    """ids [B, T] -> hidden states [B, T, hidden] (post final LN)."""
    B, T = ids.shape
    x = L.embed(params["token_embedding"], ids)
    x = x + params["position_embedding"]["embedding"][:T].to(x.dtype)
    mask = causal_mask(T, device=ids.device)
    H, hd = cfg.heads, cfg.hidden // cfg.heads
    for lp in params["layers"]:
        h = L.layer_norm(lp["ln1"], x, cfg.ln_eps)
        q = L.linear(lp["q"], h).reshape(B, T, H, hd)
        k = L.linear(lp["k"], h).reshape(B, T, H, hd)
        v = L.linear(lp["v"], h).reshape(B, T, H, hd)
        o = mha(q, k, v, mask=mask).reshape(B, T, cfg.hidden)
        x = x + L.linear(lp["out"], o)
        h = L.layer_norm(lp["ln2"], x, cfg.ln_eps)
        x = x + L.linear(lp["fc2"], L.gelu(L.linear(lp["fc1"], h)))
    return L.layer_norm(params["final_ln"], x, cfg.ln_eps)
