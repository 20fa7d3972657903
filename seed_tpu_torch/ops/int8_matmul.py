"""Int8-weight matmul kernel (counterpart of seed_tpu/ops/int8_matmul.py).

    y[M, N] = (x[M, K] @ w_q[K, N]) * scale[N]

``int8_matmul`` is the hand-written CUDA kernel that replaces seed_tpu's
``int8_matmul._kernel`` (csrc/int8_matmul.cu): the int8 weights are converted
to x's type on chip, so device memory only ever holds them as int8. On a CPU
tensor it runs ``int8_matmul_plain``; on a CUDA tensor it launches the kernel
or raises. ``layers.linear`` routes to it under seed_tpu's ``can_use_kernel``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "seed_int8_matmul": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                         + [ctypes.c_void_p]),
}


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the int8 weights in x's type
    (exact), products accumulated in fp32 over the whole K, the fp32 scale
    applied once, one rounding to x's type."""
    acc = x.float() @ w_q.float()
    return (acc * scale.float()).to(x.dtype)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] (bf16/f32), w_q [K, N] int8, scale [N] f32 -> [M, N] x.dtype.

    CPU tensors take :func:`int8_matmul_plain`; CUDA tensors launch the
    kernel of csrc/int8_matmul.cu or raise."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w_q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"int8_matmul: shapes {tuple(x.shape)} @ "
                         f"{tuple(w_q.shape)} do not chain")
    M, K = x.shape
    N = w_q.shape[1]
    if K % 128 or N % 128:
        raise ValueError(f"int8_matmul: N={N} K={K} must tile by 128")
    if x.dtype not in _DTYPES:
        raise ValueError(f"int8_matmul: x dtype {x.dtype} not supported")
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError("int8_matmul: w_q must be int8 and scale float32")
    if scale.shape != (N,):
        raise ValueError(f"int8_matmul: scale shape {tuple(scale.shape)} != {(N,)}")
    if not (w_q.device == x.device == scale.device):
        raise ValueError("int8_matmul: x, w_q and scale must share a device")
    if not (x.is_contiguous() and w_q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("int8_matmul: x, w_q and scale must be contiguous")
    if x.data_ptr() % 16 or w_q.data_ptr() % 16:
        raise ValueError("int8_matmul: x and w_q must be 16-byte aligned")
    lib = kernels.load("int8_matmul", _SIGNATURES)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.seed_int8_matmul(x.data_ptr(), w_q.data_ptr(),
                                   scale.data_ptr(), out.data_ptr(),
                                   M, N, K, _DTYPES[x.dtype], stream)
    kernels.check(err, "int8_matmul")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def _pick_block(dim: int, prefer: int) -> Optional[int]:
    for b in (prefer, 512, 256, 128):
        if b <= dim and dim % b == 0:
            return b
    return None


def can_use_kernel(m: int, k: int, n: int) -> bool:
    """seed_tpu's dispatch predicate, unchanged, so the same linears reach
    the kernel: a real M tile (>= 256: prefill, not decode) and K and N that
    tile by 128."""
    return (m >= 256
            and _pick_block(n, 512) is not None
            and _pick_block(k, 512) is not None)
