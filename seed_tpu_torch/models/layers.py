"""Functional NN primitives on plain dicts of tensors (counterpart of
seed_tpu/models/layers.py).

Conventions, as in seed_tpu:
- ``linear`` params: {"kernel": [in, out], "bias": [out]} — the [in, out]
  layout of seed_tpu, so ``x @ kernel`` and the int8 kernel's w_q [K, N]
  need no transpose.
- LayerNorm and RMSNorm compute their statistics in fp32 and cast back.
- ``gelu`` is the exact erf GELU.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.int8_matmul import (can_use_kernel, int8_matmul, int_dot,
                               w8a8_epilogue, w8a8_kernel_takes, w8a8_matmul)
from ..ops.quantization import quantize_acts
from ..parallel.local import embedding, gathered, product_operands
from ..utils.metrics_logging import span
from ..utils.tree import leaves, tree_map

Params = Dict[str, Any]


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    with span("linear", x):
        if "kernel_q" in p:
            # int8 weight-only path: per-output-channel scale in the
            # epilogue. 2-D weights with a prefill-sized M take the int8
            # kernel, which never writes a bf16 copy of the weights; the
            # rest dequantize here.
            wq = p["kernel_q"]
            if wq.dim() == 2:
                K, N = wq.shape
                lead = x.shape[:-1]
                M = 1
                for d in lead:
                    M *= d
                if can_use_kernel(M, K, N):
                    y = int8_matmul(x.reshape(M, K), wq, p["scale"])
                    y = y.reshape(*lead, N)
                else:
                    y = (x @ wq.to(x.dtype)) * p["scale"].to(x.dtype)
            else:
                y = (x @ wq.to(x.dtype)) * p["scale"].to(x.dtype)
        else:
            x, w = product_operands(x, p["kernel"])
            y = x @ w.to(x.dtype)
        if "bias" in p:
            y = y + gathered(p["bias"]).to(y.dtype)
        return y


def linear_w8a8(p: Params, x: torch.Tensor) -> torch.Tensor:
    """W8A8 linear: dynamic per-token int8 activations x int8 weights ->
    int32 on the int8 tensor cores. The int8 x int8 -> int32 product is
    exact; the only error is the two absmax quantizations (per-token
    activation row, per-output-channel weight column).
    p: {"kernel_q": int8 [in, out], "scale": [out], "bias"?: [out]}.

    seed_tpu computes this function with an XLA dot and never dispatches its
    Pallas kernel; the result is the same bit for bit either way (exact sum,
    same epilogue). Here a CUDA tensor goes through the hand-written kernel
    whenever K and N tile by 128, at every M: that covers seed_tpu's
    ``can_use_w8a8_kernel`` shapes (M >= 256) and the decode rows below them,
    for which the card has no integer matmul. Shapes that do not tile (which
    no kernel of seed_tpu takes either) go to the library product."""
    with span("linear", x):
        xq, xs = quantize_acts(x)
        wq = p["kernel_q"]
        K, N = wq.shape
        lead = x.shape[:-1]
        if x.device.type == "cuda" and not w8a8_kernel_takes(K, N):
            y = w8a8_epilogue(int_dot(xq, wq), xs, p["scale"], x.dtype)
        else:
            y = w8a8_matmul(xq.reshape(-1, K), xs.reshape(-1, 1), wq,
                            p["scale"].float(), x.dtype).reshape(*lead, N)
        if "bias" in p:
            y = y + p["bias"].to(y.dtype)
        return y


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    with span("layer_norm", x):
        orig = x.dtype
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
        return y.to(orig)


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    orig = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(orig)


def embed(p: Params, ids: torch.Tensor) -> torch.Tensor:
    # out-of-range ids clip to the table, as seed_tpu's take(mode="clip")
    table = p["embedding"]
    return embedding(table, ids.clamp(0, table.shape[0] - 1))


# --------------------------- initializers ---------------------------------
# Seeded from an explicit torch.Generator on the target device. The port's
# random init does not reproduce seed_tpu's jax.random streams; tests that
# compare the two carry seed_tpu's weights across with seed_tpu_torch.bridge.

def init_linear(gen: torch.Generator, d_in: int, d_out: int, bias: bool = True,
                dtype=torch.float32, std: Optional[float] = None,
                device="cuda") -> Params:
    std = std if std is not None else d_in ** -0.5
    k = torch.empty((d_in, d_out), device=device)
    torch.nn.init.trunc_normal_(k, 0.0, std, -2 * std, 2 * std, generator=gen)
    p = {"kernel": k.to(dtype)}
    if bias:
        p["bias"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def init_layer_norm(dim: int, dtype=torch.float32, device="cuda") -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def init_rms_norm(dim: int, dtype=torch.float32, device="cuda") -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def init_embed(gen: torch.Generator, n: int, dim: int, dtype=torch.float32,
               std: float = 0.02, device="cuda") -> Params:
    e = torch.randn((n, dim), generator=gen, device=device) * std
    return {"embedding": e.to(dtype)}


def normal(gen: torch.Generator, shape, std: float, dtype=torch.float32,
           device="cuda") -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


def cast_tree(tree, dtype):
    """Every floating leaf of a param tree in ``dtype`` (bf16 serving, fp32
    training); integer leaves (int8 codes) stay as they are."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)


def count_params(tree) -> int:
    return sum(x.numel() for x in leaves(tree))
