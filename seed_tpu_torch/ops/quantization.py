"""Int8 weight-only quantization for serving (counterpart of
seed_tpu/ops/quantization.py).

Per-output-channel absmax int8 weights with an fp32 scale folded into the
matmul epilogue: ``y = (x @ w_q) * scale`` is exact w.r.t. the per-column
quantization. ``layers.linear`` understands the quantized leaf
({"kernel_q": int8 [in, out], "scale": [out], "bias"?}), so quantized trees
drop into every model unchanged.
"""
from __future__ import annotations

import re
from typing import Any

import torch

from ..utils.tree import path_str

DEFAULT_TARGETS = (r"(q_proj|k_proj|v_proj|o_proj|gate_proj|up_proj|"
                   r"down_proj|lm_head)/kernel$")
# the four hot matmuls of every ViT block (qkv/proj/fc1/fc2); the port keeps
# the blocks as a list, so a block's index sits between "blocks" and "attn"
VIT_TARGETS = r"blocks/(\d+/)?(attn/(qkv|proj)|mlp/fc[12])/kernel$"


def quantize_weight(w: torch.Tensor) -> dict:
    """[..., in, out] float -> int8 + per-output-channel scale."""
    wf = w.float()
    absmax = wf.abs().amax(dim=-2, keepdim=True)               # per column
    scale = absmax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"kernel_q": q, "scale": scale.squeeze(-2)}


def dequantize_weight(p: dict) -> torch.Tensor:
    return p["kernel_q"].float() * p["scale"][..., None, :]


def quantize_acts(x: torch.Tensor, dim: int = -1):
    """Dynamic per-token absmax int8 activation quantization.
    Returns (q int8, scale fp32 with ``dim`` kept at size 1)."""
    xf = x.float()
    absmax = xf.abs().amax(dim=dim, keepdim=True)
    scale = absmax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_tree(params: Any, targets: str = DEFAULT_TARGETS) -> Any:
    """Quantize all kernels whose path matches ``targets``; bias and other
    leaves pass through."""
    pat = re.compile(targets)

    def walk(tree, path):
        if isinstance(tree, dict):
            if "kernel" in tree and pat.search(path_str(path + ["kernel"])):
                out = {k: v for k, v in tree.items() if k != "kernel"}
                out.update(quantize_weight(tree["kernel"]))
                return out
            return {k: walk(v, path + [k]) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path + [i]) for i, v in enumerate(tree)]
        return tree

    return walk(params, [])
