"""Int8 matmul kernels (counterpart of seed_tpu/ops/int8_matmul.py).

    int8_matmul:  y[M, N] = (x[M, K] @ w_q[K, N]) * scale[N]
    w8a8_matmul:  y[M, N] = f32(xq[M, K] @ w_q[K, N]) * x_scale[M, 1] * w_scale[N]

``int8_matmul`` is the hand-written CUDA kernel that replaces seed_tpu's
``int8_matmul._kernel`` (csrc/int8_matmul.cu): the int8 weights are converted
to x's type on chip, so device memory only ever holds them as int8. On a CPU
tensor it runs ``int8_matmul_plain``; on a CUDA tensor it launches the kernel
or raises. ``layers.linear`` routes to it under seed_tpu's ``can_use_kernel``.
``int8_plan`` picks the kernel's tile and split of K (the 8B's prefill
shapes have too few output tiles to fill the card on their own).

``w8a8_matmul`` is the hand-written kernel that replaces seed_tpu's
``_w8a8_kernel`` (csrc/w8a8_matmul.cu): int8 activations times int8 weights on
the int8 tensor cores with an exact int32 sum over the whole K, then the fp32
epilogue ``acc * x_scale * w_scale`` rounded once to the output type. On a CPU
tensor it runs ``w8a8_matmul_plain``; on a CUDA tensor it launches the kernel
or raises. ``layers.linear_w8a8`` routes every CUDA product whose K and N tile
by 128 to it (a superset of seed_tpu's ``can_use_w8a8_kernel``).
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from . import kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "seed_int8_matmul": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                         + [ctypes.c_void_p]),
    "seed_int8_matmul_smem_bytes": [ctypes.c_int],
}

# Launch plan of csrc/int8_matmul.cu: two blocks resident per SM; bf16 x
# (int8_mm_bf16) on 128 x 128 tiles, fp32 x (int8_mm_f32) on 64 x 128.
SMS = 132                  # streaming multiprocessors of the H100 SXM
BLOCKS_PER_SM = 2
TILES = {torch.bfloat16: (128, 128), torch.float32: (64, 128)}
K_CHUNK = 128              # a split covers whole chunks of K
MAX_SPLIT = 8
_W8A8_SIGNATURES = {
    "seed_w8a8_matmul": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                         + [ctypes.c_void_p]),
    "seed_w8a8_smem_bytes": [ctypes.c_int],
}


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the int8 weights in x's type
    (exact), products accumulated in fp32 over the whole K, the fp32 scale
    applied once, one rounding to x's type."""
    acc = x.float() @ w_q.float()
    return (acc * scale.float()).to(x.dtype)


def int8_plan(M: int, N: int, K: int, dtype: torch.dtype
              ) -> Tuple[int, int, int]:
    """(tile_m, tile_n, split) of the kernel for x [M, K] @ w [K, N] with
    x of ``dtype`` (its tile: :data:`TILES`).

    When the output tiles fall short of one wave (two blocks on each of the
    132 SMs), K is split into runs of whole 128-wide chunks, each run a block
    of its own: the split that minimises waves x work per block, the smallest
    on a tie, at most 8 and at most one run per chunk. Each split writes an
    fp32 partial (:func:`int8_workspace`); a second kernel sums them in split
    order."""
    tile_m, tile_n = TILES[dtype]
    tiles = -(-M // tile_m) * (N // tile_n)
    slots = SMS * BLOCKS_PER_SM
    if tiles >= slots:
        return tile_m, tile_n, 1
    cost = lambda s: -(-tiles * s // slots) / s
    splits = range(1, min(MAX_SPLIT, K // K_CHUNK) + 1)
    return tile_m, tile_n, min(splits, key=lambda s: (cost(s), s))


def int8_split_bounds(K: int, split: int) -> List[Tuple[int, int]]:
    """The K range [begin, end) of each split, as the kernel cuts it: split s
    takes chunks [s c / split, (s + 1) c / split) of the c = K / 128."""
    chunks = K // K_CHUNK
    return [(s * chunks // split * K_CHUNK, (s + 1) * chunks // split * K_CHUNK)
            for s in range(split)]


def int8_workspace(M: int, N: int, split: int) -> int:
    """fp32 elements of the split partials: split x [M, N], none unsplit."""
    return split * M * N if split > 1 else 0


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] (bf16/f32), w_q [K, N] int8, scale [N] f32 -> [M, N] x.dtype.

    CPU tensors take :func:`int8_matmul_plain`; CUDA tensors launch the
    kernel of csrc/int8_matmul.cu on :func:`int8_plan`'s tile and split of
    K (bf16 x: bf16 tensor-core products; fp32 x: two TF32 products, x's
    hi and lo halves against the exact int8 weight) or raise."""
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
    tile_m, tile_n, split = int8_plan(M, N, K, x.dtype)
    lib = kernels.load("int8_matmul", _SIGNATURES)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    workspace = torch.empty(int8_workspace(M, N, split), dtype=torch.float32,
                            device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.seed_int8_matmul(x.data_ptr(), w_q.data_ptr(),
                                   scale.data_ptr(), out.data_ptr(),
                                   workspace.data_ptr() or None, M, N, K,
                                   tile_m, tile_n, split, _DTYPES[x.dtype],
                                   stream)
    kernels.check(err, "int8_matmul")
    int8_matmul.launches += 1
    int8_matmul.launches_f32 += x.dtype == torch.float32
    return out


int8_matmul.launches = 0
int8_matmul.launches_f32 = 0     # of them, with fp32 x (int8_mm_f32)


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


# ------------------------------- W8A8 --------------------------------------

def int_dot(xq: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact integer product xq [..., K] @ w_q [K, N] -> int32, through a
    library call. |sum| <= K * 127**2 (1.8e8 at K = 11008) fits int32 but not
    fp32's 24 bits, so it is never taken in fp32: int32 on the CPU; float64 on
    the card, which has no integer matmul (every partial sum is an integer
    below 2**53, so float64 is exact)."""
    if xq.device.type == "cpu":
        return xq.to(torch.int32) @ w_q.to(torch.int32)
    return (xq.to(torch.float64) @ w_q.to(torch.float64)).to(torch.int32)


def w8a8_epilogue(acc: torch.Tensor, x_scale: torch.Tensor,
                  w_scale: torch.Tensor, out_dtype) -> torch.Tensor:
    """The exact dequant epilogue of seed_tpu's ``_w8a8_kernel``: the int32
    sums in fp32, times the per-token activation scale, times the per-column
    weight scale, in that order, one rounding to ``out_dtype``."""
    return (acc.float() * x_scale.float() * w_scale.float()).to(out_dtype)


def w8a8_matmul_plain(xq: torch.Tensor, x_scale: torch.Tensor,
                      w_q: torch.Tensor, w_scale: torch.Tensor,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the exact integer product
    (:func:`int_dot`), then the kernel's epilogue."""
    return w8a8_epilogue(int_dot(xq, w_q), x_scale, w_scale, out_dtype)


def w8a8_matmul(xq: torch.Tensor, x_scale: torch.Tensor, w_q: torch.Tensor,
                w_scale: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Fully quantized matmul ``(xq @ w_q) * x_scale * w_scale``.

    xq [M, K] int8, x_scale [M, 1] f32 (per token), w_q [K, N] int8, w_scale
    [N] f32 (per column) -> [M, N] ``out_dtype`` (bf16 or f32). Any M >= 1:
    the ragged last tile is masked inside the kernel, where seed_tpu pads M.

    CPU tensors take :func:`w8a8_matmul_plain`; CUDA tensors launch the
    kernel of csrc/w8a8_matmul.cu or raise."""
    if xq.device.type == "cpu":
        return w8a8_matmul_plain(xq, x_scale, w_q, w_scale, out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"w8a8_matmul: unsupported device {xq.device}")
    if xq.dim() != 2 or w_q.dim() != 2 or xq.shape[1] != w_q.shape[0]:
        raise ValueError(f"w8a8_matmul: shapes {tuple(xq.shape)} @ "
                         f"{tuple(w_q.shape)} do not chain")
    M, K = xq.shape
    N = w_q.shape[1]
    if M < 1 or K % 128 or N % 128:
        raise ValueError(f"w8a8_matmul: M={M} N={N} K={K}: K and N must tile "
                         "by 128")
    if out_dtype not in _DTYPES:
        raise ValueError(f"w8a8_matmul: out_dtype {out_dtype} not supported")
    if xq.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError("w8a8_matmul: xq and w_q must be int8")
    if x_scale.dtype != torch.float32 or w_scale.dtype != torch.float32:
        raise ValueError("w8a8_matmul: x_scale and w_scale must be float32")
    if x_scale.shape != (M, 1) or w_scale.shape != (N,):
        raise ValueError(f"w8a8_matmul: scale shapes {tuple(x_scale.shape)}, "
                         f"{tuple(w_scale.shape)} != {(M, 1)}, {(N,)}")
    tensors = (xq, x_scale, w_q, w_scale)
    if any(t.device != xq.device for t in tensors):
        raise ValueError("w8a8_matmul: all operands must share a device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("w8a8_matmul: all operands must be contiguous")
    if xq.data_ptr() % 16 or w_q.data_ptr() % 16:
        raise ValueError("w8a8_matmul: xq and w_q must be 16-byte aligned")
    lib = kernels.load("w8a8_matmul", _W8A8_SIGNATURES)
    out = torch.empty((M, N), dtype=out_dtype, device=xq.device)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.seed_w8a8_matmul(xq.data_ptr(), x_scale.data_ptr(),
                                   w_q.data_ptr(), w_scale.data_ptr(),
                                   out.data_ptr(), M, N, K, _DTYPES[out_dtype],
                                   stream)
    kernels.check(err, "w8a8_matmul")
    w8a8_matmul.launches += 1
    return out


w8a8_matmul.launches = 0


def w8a8_kernel_takes(k: int, n: int) -> bool:
    """What the CUDA kernel needs of a product's shape: K and N that tile by
    128. It takes every M, so on the card it also serves the decode rows
    (M < 256) that :func:`can_use_w8a8_kernel` leaves out."""
    return k >= 128 and k % 128 == 0 and n % 128 == 0


def _pick_w8a8_block(dim: int, prefer: int) -> int:
    """Largest 128-multiple divisor of ``dim`` that is <= ``prefer`` (the full
    dim when it is itself small). seed_tpu's tile choice; the CUDA kernel has
    its own tiles, and this stays for the dispatch predicate."""
    if dim <= prefer:
        return dim
    for mult in range(prefer // 128, 0, -1):
        if dim % (mult * 128) == 0:
            return mult * 128
    raise ValueError(f"dim {dim} has no 128-multiple block <= {prefer}")


def can_use_w8a8_kernel(m: int, k: int, n: int) -> bool:
    """seed_tpu's W8A8 dispatch predicate, unchanged: K and N tile by 128 and
    M is a real tile (encode / prefill / training shapes, not decode)."""
    if m < 256 or k % 128 or n % 128:
        return False
    try:
        _pick_w8a8_block(n, 1536), _pick_w8a8_block(k, 2048)
        return True
    except ValueError:
        return False
