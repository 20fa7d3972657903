"""Device-side image preprocessing (counterpart of seed_tpu/ops/preprocess.py).

uint8 [B, H, W, 3] on the device -> resize -> /255 -> CLIP normalize, with
no host round trip per image. ``resize_bicubic_pil`` reproduces PIL's
two-pass fixed-point uint8 BICUBIC resize bit for bit (the reference's
torchvision-on-PIL preprocessing); ``resize_bicubic`` is the continuous
(float) bicubic with antialiasing.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

# CLIP normalization constants (models/seed_llama_tokenizer.py:55)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

# PIL Resample.c fixed-point precision (8bpc images)
_PIL_PRECISION_BITS = 32 - 8 - 2


def normalize(images: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """float [B,H,W,3] in [0,1] -> CLIP-normalized."""
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=images.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=images.device)
    return ((images.float() - mean) / std).to(dtype)


def _pil_bicubic_weight(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    x = np.abs(x)
    w1 = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    w2 = (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return np.where(x < 1.0, w1, np.where(x < 2.0, w2, 0.0))


def _pil_bilinear_weight(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


# (weight fn, filter support) per PIL filter — Resample.c BILINEAR/BICUBIC
_PIL_FILTERS = {"bicubic": (_pil_bicubic_weight, 2.0),
                "bilinear": (_pil_bilinear_weight, 1.0)}


def _pil_weights(in_size: int, out_size: int, filt: str):
    """Per output pixel: the support window and its normalized float weights
    (PIL precompute_coeffs)."""
    weight_fn, base_support = _PIL_FILTERS[filt]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = int(max(0, np.floor(center - support)))
        xmax = int(min(in_size, np.ceil(center + support)))
        w = weight_fn((np.arange(xmin, xmax) - center + 0.5) * ss)
        yield xx, xmin, xmax, w / w.sum()


@functools.lru_cache(maxsize=64)
def _pil_coeff_matrix(in_size: int, out_size: int,
                      filt: str = "bicubic") -> np.ndarray:
    """Dense [out, in] int32 coefficients of PIL's 8bpc resampler
    (normalize_coeffs_8bpc: round-half-away quantization)."""
    kk = np.zeros((out_size, in_size), np.int32)
    for xx, xmin, xmax, w in _pil_weights(in_size, out_size, filt):
        kk[xx, xmin:xmax] = np.where(
            w >= 0, w * (1 << _PIL_PRECISION_BITS) + 0.5,
            w * (1 << _PIL_PRECISION_BITS) - 0.5).astype(np.int32)
    return kk


@functools.lru_cache(maxsize=64)
def _float_coeff_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense [out, in] float bicubic (a=-0.5) antialiasing weights."""
    kk = np.zeros((out_size, in_size), np.float64)
    for xx, xmin, xmax, w in _pil_weights(in_size, out_size, "bicubic"):
        kk[xx, xmin:xmax] = w
    return kk


def resize_bicubic(images: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Continuous antialiased bicubic resize, float [B,H,W,C] -> float32."""
    B, H, W, C = images.shape
    kh = torch.from_numpy(_float_coeff_matrix(W, size[1])).to(images.device,
                                                              torch.float32)
    kv = torch.from_numpy(_float_coeff_matrix(H, size[0])).to(images.device,
                                                              torch.float32)
    x = torch.einsum("bhwc,ow->bhoc", images.float(), kh)
    return torch.einsum("bhwc,oh->bowc", x, kv)


def resize_bicubic_pil(images_u8: torch.Tensor, size: Tuple[int, int],
                       interpolation: str = "bicubic") -> torch.Tensor:
    """BIT-EXACT ``PIL.Image.resize(size, BICUBIC)`` on uint8 images: two
    fixed-point passes (horizontal then vertical, PIL's order), each rounded,
    shifted and clipped to uint8. uint8 [B,H,W,C] -> uint8 [B,*size,C].

    The integer contractions run in float64: every product and partial sum
    is an integer below 2**53, so they are exact, and the card has float64
    matrix products where it has none for integers."""
    B, H, W, C = images_u8.shape
    dev = images_u8.device
    kh = torch.from_numpy(_pil_coeff_matrix(W, size[1], interpolation))
    kv = torch.from_numpy(_pil_coeff_matrix(H, size[0], interpolation))
    kh, kv = kh.to(dev, torch.float64), kv.to(dev, torch.float64)
    half = 1 << (_PIL_PRECISION_BITS - 1)
    x = images_u8.to(torch.float64)
    acc = torch.einsum("bhwc,ow->bhoc", x, kh).to(torch.int64)
    x = ((acc + half) >> _PIL_PRECISION_BITS).clamp(0, 255).to(torch.float64)
    acc = torch.einsum("bhwc,oh->bowc", x, kv).to(torch.int64)
    x = ((acc + half) >> _PIL_PRECISION_BITS).clamp(0, 255)
    return x.to(torch.uint8)


def preprocess(images_u8: torch.Tensor, image_size: int = 224,
               dtype=torch.bfloat16, pil_exact: bool = True) -> torch.Tensor:
    """uint8 [B,H,W,3] -> normalized [B,image_size,image_size,3] ``dtype``.

    When a resize is needed, ``pil_exact=True`` reproduces PIL's uint8 resize
    bit for bit; ``pil_exact=False`` takes the continuous float bicubic."""
    if tuple(images_u8.shape[1:3]) != (image_size, image_size):
        if pil_exact:
            images_u8 = resize_bicubic_pil(images_u8, (image_size, image_size))
            x = images_u8.float() / 255.0
        else:
            x = resize_bicubic(images_u8.float() / 255.0,
                               (image_size, image_size))
    else:
        x = images_u8.float() / 255.0
    return normalize(x, dtype)
