"""Device-side image preprocessing (counterpart of seed_tpu/ops/preprocess.py).

uint8 [B, H, W, 3] on the device -> resize -> /255 -> CLIP normalize, with
no host round trip per image. ``resize_bicubic_pil`` reproduces PIL's
two-pass fixed-point uint8 BICUBIC resize bit for bit (the reference's
torchvision-on-PIL preprocessing); ``resize_bicubic`` is the continuous
(float) bicubic with antialiasing.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.metrics_logging import span

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
    with span("preprocess", images_u8, images=images_u8.shape[0]):
        size = (image_size, image_size)
        if tuple(images_u8.shape[1:3]) != size:
            if pil_exact:
                images_u8 = resize_bicubic_pil(images_u8, size)
                x = images_u8.float() / 255.0
            else:
                x = resize_bicubic(images_u8.float() / 255.0, size)
        else:
            x = images_u8.float() / 255.0
        return normalize(x, dtype)


def _scale_translate_weights(in_size: int, out_size: int, scale: torch.Tensor,
                            translation: torch.Tensor) -> torch.Tensor:
    """Per example, the [out, in] bilinear weights of
    ``jax.image.scale_and_translate(..., method="bilinear")`` (antialias on):
    output pixel i samples the input at (i + 0.5 - translation) / scale -
    0.5 with a triangle kernel widened by 1 / scale when it downscales; each
    row of weights is normalised, and a sample outside the input gets none.
    scale, translation [B] fp32 -> [B, out, in] fp32."""
    dev = scale.device
    inv = (1.0 / scale.float())[:, None]                            # [B, 1]
    kernel_scale = inv.clamp_min(1.0)
    sample = ((torch.arange(out_size, device=dev, dtype=torch.float32) + 0.5)
              * inv - translation.float()[:, None] * inv - 0.5)    # [B, out]
    src = torch.arange(in_size, device=dev, dtype=torch.float32)
    x = (sample[:, :, None] - src).abs() / kernel_scale[:, :, None]
    w = (1.0 - x).clamp_min(0.0)                                   # [B, out, in]
    total = w.sum(-1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, :, None], w, torch.zeros_like(w))


def random_resized_crop_flip(
    images: torch.Tensor,           # float [B, H, W, 3] in [0, 1]
    image_size: int = 224,
    scale: Tuple[float, float] = (0.5, 1.0),
    flip: bool = True,
    dtype=torch.float32,
    gen: Optional[torch.Generator] = None,
    draws: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Training augmentation (blip2_image_train, blip_processors.py:226+):
    per example a random-area square crop, resized to ``image_size`` by
    scale-and-translate (bilinear, antialiased), a horizontal flip, then the
    CLIP normalization; batched on the device.

    The draws are ``draws`` = (area [B] in ``scale``, the crop's offsets as
    fractions u_h, u_w [B] in [0, 1) of the room left, flips [B] bool) when
    given, else drawn from ``gen``."""
    B, H, W, _ = images.shape
    dev = images.device
    if draws is None:
        area = scale[0] + (scale[1] - scale[0]) * torch.rand(
            B, generator=gen, device=dev)
        u_h = torch.rand(B, generator=gen, device=dev)
        u_w = torch.rand(B, generator=gen, device=dev)
        flips = torch.rand(B, generator=gen, device=dev) < 0.5
    else:
        area, u_h, u_w, flips = (torch.as_tensor(d, device=dev) for d in draws)
    side = area.float().sqrt()                  # aspect kept at 1
    off_h = u_h.float() * ((1.0 - side) * H)
    off_w = u_w.float() * ((1.0 - side) * W)
    sc = image_size / (side * H)
    kv = _scale_translate_weights(H, image_size, sc, -off_h * sc)
    kh = _scale_translate_weights(W, image_size, sc, -off_w * sc)
    out = torch.einsum("bhwc,boh->bowc", images.float(), kv)
    out = torch.einsum("bhwc,bow->bhoc", out, kh)
    if flip:
        out = torch.where(flips.bool()[:, None, None, None], out.flip(2), out)
    return normalize(out.clamp(0.0, 1.0), dtype)


def center_crop_resize(images_u8: torch.Tensor, image_size: int = 224,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """Resize-shortest-side + center-crop variant (models/transforms.py:8-12)
    through the continuous bicubic: resize so the short side equals
    ``image_size``, then crop the long side's centre."""
    b, h, w, c = images_u8.shape
    x = images_u8.float() / 255.0
    if h < w:
        new_h, new_w = image_size, max(image_size, round(w * image_size / h))
    else:
        new_h, new_w = max(image_size, round(h * image_size / w)), image_size
    x = resize_bicubic(x, (new_h, new_w))
    top = (new_h - image_size) // 2
    left = (new_w - image_size) // 2
    x = x[:, top:top + image_size, left:left + image_size, :]
    return normalize(x, dtype)


def torchvision_resize_size(h: int, w: int, short: int) -> Tuple[int, int]:
    """torchvision ``transforms.Resize(short)`` output size: the short side
    becomes ``short`` and the long side scales with int() TRUNCATION
    (torchvision functional_pil.resize semantics, NOT round())."""
    if (w <= h and w == short) or (h <= w and h == short):
        return h, w
    if w < h:
        return int(short * h / w), short
    return short, int(short * w / h)


def torchvision_crop_box(h: int, w: int, size: int) -> Tuple[int, int]:
    """torchvision ``transforms.CenterCrop(size)`` top/left: uses
    ``int(round((dim - size) / 2.0))``, Python banker's rounding, which
    differs from floor on odd differences (e.g. diff 7 -> top 4 not 3)."""
    return int(round((h - size) / 2.0)), int(round((w - size) / 2.0))


def center_crop_resize_pil(images_u8: torch.Tensor, image_size: int = 224,
                           interpolation: str = "bilinear",
                           dtype=torch.bfloat16) -> torch.Tensor:
    """BIT-EXACT ``Resize(image_size) + CenterCrop(image_size)``, the
    reference's keep_ratio=True transform branch (torchvision defaults:
    BILINEAR interpolation, truncating short-side size math,
    banker's-rounded crop offsets), followed by ToTensor + CLIP Normalize,
    on the device.

    uint8 [B,H,W,3] -> normalized [B,image_size,image_size,3] ``dtype``."""
    b, h, w, c = images_u8.shape
    new_h, new_w = torchvision_resize_size(h, w, image_size)
    if (new_h, new_w) != (h, w):
        images_u8 = resize_bicubic_pil(images_u8, (new_h, new_w),
                                       interpolation=interpolation)
    top, left = torchvision_crop_box(new_h, new_w, image_size)
    x = images_u8[:, top:top + image_size, left:left + image_size, :]
    return normalize(x.float() / 255.0, dtype)
