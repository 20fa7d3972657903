"""Inception-v3 pool3 and logits network of FID and the Inception Score
(counterpart of seed_tpu/eval/inception.py; the reference's pytorch-fid
InceptionV3 wrapper over torchvision).

Layout and numerics, as in seed_tpu:

- activations are NHWC at every edge, conv kernels OIHW stored
  channels_last (what ``convert.convert_inception_torch`` writes and
  ``bridge.convs_to_oihw`` makes of seed_tpu's HWIO); a conv hands
  F.conv2d the NCHW view of the NHWC tensor, so nothing is copied;
- every BasicConv2d is conv -> the folded eval-mode BatchNorm (a
  per-channel scale, then a bias) -> ReLU;
- ``inception_pool3`` resizes to 299 with ``align_corners=True``
  (inception.py:112) and remaps the channels ``x * (std / 0.5) +
  (mean - 0.5) / 0.5`` (:115-118);
- max pool 3x3 stride 2 without padding; the branch pools are 3x3 stride 1
  with padding 1 and ``count_include_pad=True``;
- ``inception_logits`` resizes with bilinear sampling at half-pixel centres
  and antialiasing (``jax.image.resize`` in seed_tpu, which filters when it
  downsamples; the reference's ``nn.Upsample`` does not, ROADMAP.md
  section 3).

No kernel of the port runs here: the convolutions are cuDNN's on the card.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device

BN_EPS = 1e-3  # torchvision BasicConv2d BatchNorm2d(eps=0.001)

# name -> (c_in, c_out, (kh, kw), (sh, sw), (ph, pw)): torchvision's
# inception_v3 layer table, flattened with dotted module paths
_A = lambda pre, cin, pool: {
    f"{pre}.branch1x1": (cin, 64, (1, 1), (1, 1), (0, 0)),
    f"{pre}.branch5x5_1": (cin, 48, (1, 1), (1, 1), (0, 0)),
    f"{pre}.branch5x5_2": (48, 64, (5, 5), (1, 1), (2, 2)),
    f"{pre}.branch3x3dbl_1": (cin, 64, (1, 1), (1, 1), (0, 0)),
    f"{pre}.branch3x3dbl_2": (64, 96, (3, 3), (1, 1), (1, 1)),
    f"{pre}.branch3x3dbl_3": (96, 96, (3, 3), (1, 1), (1, 1)),
    f"{pre}.branch_pool": (cin, pool, (1, 1), (1, 1), (0, 0)),
}
_B = lambda pre, cin: {
    f"{pre}.branch3x3": (cin, 384, (3, 3), (2, 2), (0, 0)),
    f"{pre}.branch3x3dbl_1": (cin, 64, (1, 1), (1, 1), (0, 0)),
    f"{pre}.branch3x3dbl_2": (64, 96, (3, 3), (1, 1), (1, 1)),
    f"{pre}.branch3x3dbl_3": (96, 96, (3, 3), (2, 2), (0, 0)),
}
_C = lambda pre, c7: {
    f"{pre}.branch1x1": (768, 192, (1, 1), (1, 1), (0, 0)),
    f"{pre}.branch7x7_1": (768, c7, (1, 1), (1, 1), (0, 0)),
    f"{pre}.branch7x7_2": (c7, c7, (1, 7), (1, 1), (0, 3)),
    f"{pre}.branch7x7_3": (c7, 192, (7, 1), (1, 1), (3, 0)),
    f"{pre}.branch7x7dbl_1": (768, c7, (1, 1), (1, 1), (0, 0)),
    f"{pre}.branch7x7dbl_2": (c7, c7, (7, 1), (1, 1), (3, 0)),
    f"{pre}.branch7x7dbl_3": (c7, c7, (1, 7), (1, 1), (0, 3)),
    f"{pre}.branch7x7dbl_4": (c7, c7, (7, 1), (1, 1), (3, 0)),
    f"{pre}.branch7x7dbl_5": (c7, 192, (1, 7), (1, 1), (0, 3)),
    f"{pre}.branch_pool": (768, 192, (1, 1), (1, 1), (0, 0)),
}
_D = lambda pre: {
    f"{pre}.branch3x3_1": (768, 192, (1, 1), (1, 1), (0, 0)),
    f"{pre}.branch3x3_2": (192, 320, (3, 3), (2, 2), (0, 0)),
    f"{pre}.branch7x7x3_1": (768, 192, (1, 1), (1, 1), (0, 0)),
    f"{pre}.branch7x7x3_2": (192, 192, (1, 7), (1, 1), (0, 3)),
    f"{pre}.branch7x7x3_3": (192, 192, (7, 1), (1, 1), (3, 0)),
    f"{pre}.branch7x7x3_4": (192, 192, (3, 3), (2, 2), (0, 0)),
}
_E = lambda pre, cin: {
    f"{pre}.branch1x1": (cin, 320, (1, 1), (1, 1), (0, 0)),
    f"{pre}.branch3x3_1": (cin, 384, (1, 1), (1, 1), (0, 0)),
    f"{pre}.branch3x3_2a": (384, 384, (1, 3), (1, 1), (0, 1)),
    f"{pre}.branch3x3_2b": (384, 384, (3, 1), (1, 1), (1, 0)),
    f"{pre}.branch3x3dbl_1": (cin, 448, (1, 1), (1, 1), (0, 0)),
    f"{pre}.branch3x3dbl_2": (448, 384, (3, 3), (1, 1), (1, 1)),
    f"{pre}.branch3x3dbl_3a": (384, 384, (1, 3), (1, 1), (0, 1)),
    f"{pre}.branch3x3dbl_3b": (384, 384, (3, 1), (1, 1), (1, 0)),
    f"{pre}.branch_pool": (cin, 192, (1, 1), (1, 1), (0, 0)),
}

INCEPTION_CONVS: Dict[str, Tuple] = {
    "Conv2d_1a_3x3": (3, 32, (3, 3), (2, 2), (0, 0)),
    "Conv2d_2a_3x3": (32, 32, (3, 3), (1, 1), (0, 0)),
    "Conv2d_2b_3x3": (32, 64, (3, 3), (1, 1), (1, 1)),
    "Conv2d_3b_1x1": (64, 80, (1, 1), (1, 1), (0, 0)),
    "Conv2d_4a_3x3": (80, 192, (3, 3), (1, 1), (0, 0)),
    **_A("Mixed_5b", 192, 32), **_A("Mixed_5c", 256, 64),
    **_A("Mixed_5d", 288, 64),
    **_B("Mixed_6a", 288),
    **_C("Mixed_6b", 128), **_C("Mixed_6c", 160), **_C("Mixed_6d", 160),
    **_C("Mixed_6e", 192),
    **_D("Mixed_7a"),
    **_E("Mixed_7b", 1280), **_E("Mixed_7c", 2048),
}

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def init_inception(gen: torch.Generator, dtype=torch.float32,
                   with_fc: bool = False, device="cuda"):
    """Seeded random weights on ``device`` (the card by default); real use
    loads converted torchvision weights (``convert_inception_torch``).
    ``with_fc`` adds the 1000-way classifier head of the Inception Score."""
    device = resolve_device(device)
    params = {}
    for name, (cin, cout, k, _, _) in INCEPTION_CONVS.items():
        fan_in = cin * k[0] * k[1]
        w = torch.randn((cout, cin, *k), generator=gen, device=device)
        params[name] = {
            "kernel": (w * (2.0 / fan_in) ** 0.5).to(dtype).contiguous(
                memory_format=torch.channels_last),
            "scale": torch.ones((cout,), dtype=dtype, device=device),
            "bias": torch.zeros((cout,), dtype=dtype, device=device),
        }
    if with_fc:
        w = torch.randn((2048, 1000), generator=gen, device=device)
        params["fc"] = {"kernel": (w * 2048 ** -0.5).to(dtype),
                        "bias": torch.zeros((1000,), dtype=dtype,
                                            device=device)}
    return params


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _conv(p, x: torch.Tensor, name: str) -> torch.Tensor:
    _, _, _, stride, pad = INCEPTION_CONVS[name]
    p = p[name]
    y = _nhwc(F.conv2d(_nchw(x), p["kernel"].to(x.dtype), None, stride, pad))
    return torch.relu(y * p["scale"].to(y.dtype) + p["bias"].to(y.dtype))


def _max_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    # no padding: every window is whole, so the reduction's initial value
    # (seed_tpu: -inf in fp32, the dtype's minimum otherwise) never shows
    return _nhwc(F.max_pool2d(_nchw(x), 3, 2))


def _avg_pool_3x3s1p1(x: torch.Tensor) -> torch.Tensor:
    # AvgPool2d(3, 1, padding=1) with count_include_pad: / 9 at borders too
    return _nhwc(F.avg_pool2d(_nchw(x), 3, 1, 1, count_include_pad=True))


def _chain(p, x, pre: str, names) -> torch.Tensor:
    for n in names:
        x = _conv(p, x, f"{pre}.{n}")
    return x


def _mixed_a(p, x, pre):
    return torch.cat([
        _conv(p, x, f"{pre}.branch1x1"),
        _chain(p, x, pre, ("branch5x5_1", "branch5x5_2")),
        _chain(p, x, pre, ("branch3x3dbl_1", "branch3x3dbl_2",
                           "branch3x3dbl_3")),
        _conv(p, _avg_pool_3x3s1p1(x), f"{pre}.branch_pool")], -1)


def _mixed_b(p, x, pre):
    return torch.cat([
        _conv(p, x, f"{pre}.branch3x3"),
        _chain(p, x, pre, ("branch3x3dbl_1", "branch3x3dbl_2",
                           "branch3x3dbl_3")),
        _max_pool_3x3s2(x)], -1)


def _mixed_c(p, x, pre):
    return torch.cat([
        _conv(p, x, f"{pre}.branch1x1"),
        _chain(p, x, pre, ("branch7x7_1", "branch7x7_2", "branch7x7_3")),
        _chain(p, x, pre, ("branch7x7dbl_1", "branch7x7dbl_2",
                           "branch7x7dbl_3", "branch7x7dbl_4",
                           "branch7x7dbl_5")),
        _conv(p, _avg_pool_3x3s1p1(x), f"{pre}.branch_pool")], -1)


def _mixed_d(p, x, pre):
    return torch.cat([
        _chain(p, x, pre, ("branch3x3_1", "branch3x3_2")),
        _chain(p, x, pre, ("branch7x7x3_1", "branch7x7x3_2", "branch7x7x3_3",
                           "branch7x7x3_4")),
        _max_pool_3x3s2(x)], -1)


def _mixed_e(p, x, pre):
    b3 = _conv(p, x, f"{pre}.branch3x3_1")
    bd = _chain(p, x, pre, ("branch3x3dbl_1", "branch3x3dbl_2"))
    return torch.cat([
        _conv(p, x, f"{pre}.branch1x1"),
        _conv(p, b3, f"{pre}.branch3x3_2a"),
        _conv(p, b3, f"{pre}.branch3x3_2b"),
        _conv(p, bd, f"{pre}.branch3x3dbl_3a"),
        _conv(p, bd, f"{pre}.branch3x3dbl_3b"),
        _conv(p, _avg_pool_3x3s1p1(x), f"{pre}.branch_pool")], -1)


@functools.lru_cache(maxsize=8)
def _align_corners_coeffs(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] bilinear matrix of torch's align_corners=True sampling:
    src = i * (in - 1) / (out - 1)."""
    m = np.zeros((out_size, in_size), np.float32)
    if in_size == 1 or out_size == 1:
        m[:, 0] = 1.0
        return m
    src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).astype(np.float32)
    m[np.arange(out_size), lo] += 1.0 - frac
    m[np.arange(out_size), hi] += frac
    return m


def resize_bilinear_align_corners(x: torch.Tensor,
                                  size: Tuple[int, int]) -> torch.Tensor:
    """torch ``F.upsample(mode='bilinear', align_corners=True)`` on NHWC,
    as two fp32 contractions (rows, then columns), seed_tpu's order."""
    B, H, W, C = x.shape
    kv = torch.from_numpy(_align_corners_coeffs(H, size[0])).to(x.device)
    kh = torch.from_numpy(_align_corners_coeffs(W, size[1])).to(x.device)
    y = torch.einsum("bhwc,oh->bowc", x.float(), kv)
    return torch.einsum("bhwc,ow->bhoc", y, kh)


def resize_bilinear_antialias(x: torch.Tensor,
                              size: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, ..., "bilinear")`` on NHWC: half-pixel centres,
    and a triangle kernel widened by the scale when it downsamples (torch's
    ``antialias=True``). fp32."""
    return _nhwc(F.interpolate(_nchw(x.float()), size=size, mode="bilinear",
                               align_corners=False, antialias=True))


def _trunk(params, x: torch.Tensor) -> torch.Tensor:
    """Blocks 0-3 and the global average pool: [B, H, W, 3] -> [B, 2048]."""
    for name in ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3"):
        x = _conv(params, x, name)
    x = _max_pool_3x3s2(x)
    x = _conv(params, _conv(params, x, "Conv2d_3b_1x1"), "Conv2d_4a_3x3")
    x = _max_pool_3x3s2(x)
    for pre in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
        x = _mixed_a(params, x, pre)
    x = _mixed_b(params, x, "Mixed_6a")
    for pre in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
        x = _mixed_c(params, x, pre)
    x = _mixed_d(params, x, "Mixed_7a")
    x = _mixed_e(params, x, "Mixed_7b")
    x = _mixed_e(params, x, "Mixed_7c")
    return x.mean(dim=(1, 2))                    # AdaptiveAvgPool2d((1, 1))


@torch.no_grad()
def inception_pool3(params, images01: torch.Tensor, resize_input: bool = True,
                    normalize_input: bool = True,
                    dtype=torch.float32) -> torch.Tensor:
    """[B, H, W, 3] images in [0, 1] (NHWC) -> [B, 2048] pool3 features.

    InceptionV3.forward (inception.py:93-124) with output_blocks=[3]: the
    align-corners resize to 299, the channel remap, blocks 0-3, the global
    average pool. The network runs in ``dtype``: fp32 is seed_tpu's
    numerics; bf16 is the port's faster option (resize and remap stay
    fp32)."""
    x = images01
    if resize_input:
        x = resize_bilinear_align_corners(x, (299, 299))
    x = x.float()
    if normalize_input:
        std = torch.tensor(IMAGENET_STD, device=x.device) / 0.5
        mean = (torch.tensor(IMAGENET_MEAN, device=x.device) - 0.5) / 0.5
        x = x * std + mean
    return _trunk(params, x.to(dtype))


@torch.no_grad()
def inception_logits(params, images_pm1: torch.Tensor,
                     resize_input: bool = True) -> torch.Tensor:
    """[B, H, W, 3] images in [-1, 1] (NHWC) -> [B, 1000] classifier logits
    (the Inception-Score path, inception_score.py:35-43): torchvision
    ``inception_v3(transform_input=False)`` on raw [-1, 1] pixels, resized
    to 299 bilinearly at half-pixel centres with antialiasing, as seed_tpu's
    ``jax.image.resize``; trunk, pool, fc. Needs ``params["fc"]``."""
    x = images_pm1.float()
    if resize_input:
        x = resize_bilinear_antialias(x, (299, 299))
    pool = _trunk(params, x)
    fc = params["fc"]
    return pool @ fc["kernel"].to(pool.dtype) + fc["bias"].to(pool.dtype)


def inception_probs(params, images_pm1: torch.Tensor,
                    resize_input: bool = True) -> torch.Tensor:
    """Class probabilities for ``metrics.inception_score`` (the reference
    softmaxes the logits, inception_score.py:43)."""
    logits = inception_logits(params, images_pm1, resize_input)
    return torch.softmax(logits, dim=-1)
