"""Vector quantization, the 8192 x 32 SEED codebook (counterpart of
seed_tpu/models/quantizer.py): nearest codes, lookup, and the
straight-through ``quantize`` of stage-2 training. The gumbel, EMA,
normalized-EMA and k-means variants are not ported yet (ROADMAP.md).

Token ids are the interface, so the nearest-code distance
``d = |z|^2 + |e|^2 - 2 z.e`` is computed in fp32 whatever the activation
dtype, and argmin ties go to the lowest index (torch.argmin returns the
first minimum, as jnp.argmin does).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class VQResult(NamedTuple):
    quantized: torch.Tensor   # [B, N, D] straight-through codes
    indices: torch.Tensor     # [B, N] int32 code ids
    loss: torch.Tensor        # commitment + codebook loss (scalar)


def init_codebook(gen, n_codes: int = 8192, dim: int = 32,
                  dtype=torch.float32, device="cuda"):
    # uniform(-1/n, 1/n) matches VectorQuantizer2.__init__ (:39)
    e = torch.rand((n_codes, dim), generator=gen, device=device)
    e = (e * 2.0 - 1.0) / n_codes
    return {"codebook": e.to(dtype)}


def nearest_codes(codebook: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """argmin_j |z_i - e_j|^2 in fp32. z [..., D] -> int32 [...]."""
    zf = z.float()
    e = codebook.float()
    d = ((zf * zf).sum(dim=-1, keepdim=True)
         + (e * e).sum(dim=-1)
         - 2.0 * torch.einsum("...d,nd->...n", zf, e))
    return d.argmin(dim=-1).to(torch.int32)


def lookup(params, indices: torch.Tensor) -> torch.Tensor:
    """Codebook entry lookup; out-of-range ids clamp to the nearest code."""
    cb = params["codebook"]
    return cb[indices.long().clamp(0, cb.shape[0] - 1)]


def quantize(params, z: torch.Tensor, beta: float = 0.25,
             legacy: bool = True) -> VQResult:
    """Straight-through VQ with the reference's legacy placement of beta
    (qformer_quantizer.py:104-107): with ``legacy`` beta weighs the codebook
    term, not the commitment term."""
    cb = params["codebook"]
    idx = nearest_codes(cb, z)
    z_q = cb[idx.long()].to(z.dtype)
    zf, zqf = z.float(), z_q.float()
    commit = (zqf.detach() - zf).square().mean()
    codebook = (zqf - zf.detach()).square().mean()
    loss = commit + beta * codebook if legacy else beta * commit + codebook
    return VQResult(z + (z_q - z).detach(), idx, loss)   # straight-through
