"""The yardstick's table of peaks and its bound arithmetic.

Frozen copies: ``bound_ms`` and ``split_tf32_bounds`` are copied from
``chip_smoke.py`` (its constants block and the two functions of the same
names), so that a later change to the program cannot move the benchmark's
yardstick. The peaks are NVIDIA's H100 SXM data sheet, dense rates without
sparsity, at the card's full 700 W power limit.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12             # dense bf16 tensor-core peak
FP32_FLOPS = 67e12              # fp32 outside the tensor cores
TF32_FLOPS = 495e12             # dense TF32 tensor-core peak
INT8_OPS = 1979e12              # dense int8 tensor-core peak


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    """Least time of a call that moves ``nbytes`` and does ``flops`` at
    ``peak_flops``: (ms, "bytes" | "operations"), whichever bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def split_tf32_bounds(nbytes: float, flops: float, products: int) -> dict:
    """The bound of an fp32 kernel whose products run as split TF32 on the
    tensor cores: ``products`` TF32 products for each fp32 one at the TF32
    peak; the same fp32 operations on the FMA units as
    ``bound_fp32_fma_ms``."""
    bms, by = bound_ms(nbytes, products * flops, TF32_FLOPS)
    return dict(bound_ms=bms, bound_by=by,
                bound_fp32_fma_ms=bound_ms(nbytes, flops, FP32_FLOPS)[0])
