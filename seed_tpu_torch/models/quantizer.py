"""Vector quantization, the 8192 x 32 SEED codebook (counterpart of
seed_tpu/models/quantizer.py; the training variants are not ported yet).

Token ids are the interface, so the nearest-code distance
``d = |z|^2 + |e|^2 - 2 z.e`` is computed in fp32 whatever the activation
dtype, and argmin ties go to the lowest index (torch.argmin returns the
first minimum, as jnp.argmin does).
"""
from __future__ import annotations

import torch


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
