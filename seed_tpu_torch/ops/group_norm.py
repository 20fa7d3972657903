"""GroupNorm, optionally followed by SiLU, over NHWC activations: the
de-tokenizer's norms (``models/unclip/unet.group_norm``, which the VAE calls
too).

``group_norm_kernel`` is a hand-written CUDA kernel of the port
(csrc/group_norm.cu) with no TPU counterpart: seed_tpu normalises with plain
jnp ops, which XLA fuses on the TPU, while the same chain in PyTorch runs as
about 14 passes a norm and a SiLU pass after it. On a CPU tensor the wrapper
runs ``group_norm_plain``; on a CUDA tensor it launches the kernel or raises,
and counts the call in ``group_norm_kernel.launches``. It has two designs,
chosen by ``group_norm_plan`` from the shape: resident (one launch, a block
a (sample, group) holding the group's slice) for the small levels, and
streaming (two launches: per-block statistics, then the normalisation) for
the rest. ``group_norm_route`` says, from the input alone, which calls the
UNet and VAE send to it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import kernels

# the launch plan of csrc/group_norm.cu: a block reads R whole pixel rows of
# C / 8 16-byte vectors (at most MAX_THREADS threads), U rows a thread a
# chunk; about two blocks an SM
SMS = 132                   # streaming multiprocessors of the H100 SXM
BLOCKS_PER_SM = 2
MAX_THREADS = 384
MAX_CHANNELS = 8 * MAX_THREADS
MAX_GROUPS = 64
ROWS_PER_THREAD = (4, 2, 1)
# the resident design: one block a (sample, group) holds the group's slice,
# an even number of channels up to RESIDENT_MAX_CG. The kernel takes slices
# up to 200 KiB; the plan gives it those up to RESIDENT_BYTES, below which it
# beat the streaming design on the H100 at every de-tokenizer shape (above,
# its B * groups blocks leave half the SMs idle and read too slowly)
RESIDENT_BYTES = 96 * 1024
RESIDENT_MAX_CG = 256

_SIGNATURES = {
    "seed_group_norm": ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                        + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    "seed_group_norm_smem_bytes": [ctypes.c_int],
}


def group_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     groups: int, eps: float = 1e-5,
                     silu: bool = False) -> torch.Tensor:
    """GroupNorm of x [B, H, W, C] in plain PyTorch, seed_tpu's op order:
    fp32 statistics of each (sample, group) over H, W and its C / groups
    channels, the variance as the mean of squared deviations, the fp32
    affine with ``scale`` and ``bias`` in fp32, SiLU on the fp32 value where
    ``silu``, one rounding to x's type. The kernel's function, but for the
    order of its sums and the kernel's fast exp and division in SiLU (a few
    fp32 ulps)."""
    B, H, W, C = x.shape
    xf = x.float().reshape(B, H, W, groups, C // groups)
    mean = xf.mean(dim=(1, 2, 4), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 2, 4), keepdim=True)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(B, H, W, C)
    y = xf * scale.float() + bias.float()
    return (F.silu(y) if silu else y).to(x.dtype)


def resident_fits(N: int, C: int, groups: int) -> bool:
    """Whether the plan gives a shape the resident design: a group's slice
    of N positions and C / groups channels, an even number up to
    RESIDENT_MAX_CG, in RESIDENT_BYTES."""
    Cg = C // groups
    return Cg % 2 == 0 and Cg <= RESIDENT_MAX_CG and N * Cg * 2 <= RESIDENT_BYTES


def streaming_plan(B: int, N: int, C: int) -> Tuple[int, int, int]:
    """(R, U, Sb) of the streaming design for B samples of N positions and C
    channels: a block of R * C / 8 threads reads R pixel rows at once, a
    chunk is R * U rows, and each sample's chunks are cut into Sb runs, one
    block each.

    U is the largest of 4, 2, 1 rows a thread whose chunks give every SM two
    blocks over the batch (1 where none does), and Sb covers about two blocks
    an SM, at most one a chunk. Decided from the shape alone."""
    V = C // 8
    R = max(1, MAX_THREADS // V)
    slots = SMS * BLOCKS_PER_SM
    for U in ROWS_PER_THREAD:
        chunks = -(-N // (R * U))
        if B * chunks >= slots:
            break
    return R, U, min(chunks, -(-slots // B))


def group_norm_plan(B: int, N: int, C: int, groups: int
                    ) -> Tuple[bool, int, int, int]:
    """(resident, R, U, Sb): the resident design where the group's slice
    fits one block (R, U, Sb unused: 0), else the streaming design on
    :func:`streaming_plan`. Decided from the shape alone."""
    if resident_fits(N, C, groups):
        return True, 0, 0, 0
    return (False, *streaming_plan(B, N, C))


def group_norm_route(x: torch.Tensor, groups: int) -> bool:
    """Whether ``unet.group_norm`` sends x to the kernel, decided from x
    alone: a bf16 CUDA tensor (not a DTensor), non-empty [B, H, W, C],
    contiguous and 16-byte aligned, C a multiple of 8 up to MAX_CHANNELS in
    at most MAX_GROUPS equal groups. fp32, the CPU and every other layout
    take the plain chain."""
    from ..parallel.local import is_sharded
    if (is_sharded(x) or x.device.type != "cuda" or x.dtype != torch.bfloat16
            or len(x.shape) != 4 or min(x.shape) == 0):
        return False
    C = x.shape[3]
    return (C % groups == 0 and C % 8 == 0 and C <= MAX_CHANNELS
            and groups <= MAX_GROUPS and x.is_contiguous()
            and x.data_ptr() % 16 == 0)


def group_norm_kernel(x: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, groups: int, eps: float = 1e-5,
                      silu: bool = False,
                      stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm (+ SiLU where ``silu``) of x [B, H, W, C] bf16 with
    ``scale`` and ``bias`` [C] (fp32 or bf16): :func:`group_norm_plain`'s
    function. ``stats``, an fp32 [B, groups, 2] tensor, receives each
    group's mean and variance.

    CPU tensors take :func:`group_norm_plain`; CUDA tensors launch the
    kernels of csrc/group_norm.cu on :func:`group_norm_plan`'s plan (the
    streaming design with a workspace of per-block partials from torch's
    allocator, so a CUDA graph can capture the call), or raise. The launch
    runs inside an autograd function: the profiler records it as an
    operation and links its kernels to it, and so to the span around the
    call; it has no gradient."""
    if x.device.type == "cpu":
        return group_norm_plain(x, scale, bias, groups, eps, silu)
    out = _GroupNormKernel.apply(x, scale, bias, groups, eps, silu, stats)
    group_norm_kernel.launches += 1
    return out


group_norm_kernel.launches = 0


class _GroupNormKernel(torch.autograd.Function):
    """The kernel's launch as one operation, forward only (the de-tokenizer
    takes no gradient through its norms)."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, silu, stats):
        return _launch(x, scale, bias, groups, eps, silu, stats)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("group_norm_kernel has no backward")


def _launch(x, scale, bias, groups, eps, silu, stats):
    if not group_norm_route(x, groups):
        raise ValueError(f"group_norm_kernel: x {x.dtype} {tuple(x.shape)} on "
                         f"{x.device} with {groups} groups is not a shape the "
                         "kernel takes (see group_norm_route)")
    B, H, W, C = x.shape
    for name, t in (("scale", scale), ("bias", bias)):
        if (t.shape != (C,) or t.dtype != scale.dtype or t.device != x.device
                or t.dtype not in (torch.float32, torch.bfloat16)
                or not t.is_contiguous()):
            raise ValueError(f"group_norm_kernel: {name} must be a contiguous "
                             f"fp32 or bf16 [{C}] on x's device, like scale")
    if stats is not None and (stats.shape != (B, groups, 2)
                              or stats.dtype != torch.float32
                              or stats.device != x.device
                              or not stats.is_contiguous()):
        raise ValueError("group_norm_kernel: stats must be a contiguous fp32 "
                         f"[{B}, {groups}, 2] on x's device")
    resident, R, U, Sb = group_norm_plan(B, H * W, C, groups)
    lib = kernels.load("group_norm", _SIGNATURES)
    out = torch.empty_like(x)
    workspace = (None if resident else
                 torch.empty((B, Sb, groups, 2), dtype=torch.float32,
                             device=x.device))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.seed_group_norm(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            int(scale.dtype == torch.bfloat16), out.data_ptr(),
            None if resident else workspace.data_ptr(),
            None if stats is None else stats.data_ptr(),
            B, H * W, C, groups, int(resident), R, U, Sb, float(eps),
            int(silu), stream)
    kernels.check(err, "group_norm_kernel")
    return out
