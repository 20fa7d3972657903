"""Vector quantization, the 8192 x 32 SEED codebook (counterpart of
seed_tpu/models/quantizer.py): nearest codes, lookup, and the
straight-through ``quantize`` of stage-2 training, and the training
variants of the discrete vision model: the gumbel-softmax quantizer, the EMA
and normalized-EMA codebooks, and the k-means codebook init.

Token ids are the interface, so the nearest-code distance
``d = |z|^2 + |e|^2 - 2 z.e`` is computed in fp32 whatever the activation
dtype, and argmin ties go to the lowest index (torch.argmin returns the
first minimum, as jnp.argmin does).

Torch cannot reproduce ``jax.random``: where seed_tpu draws (the gumbel
noise, the k-means seeds) the port draws from an explicit
``torch.Generator``, or takes the draws from the caller.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .. import resolve_device


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


# ---- Gumbel-softmax quantizer (GumbelQuantize training variant,
#      SEED_Tokenizer/lavis/models/quantize_semantic.py:110-199) ------------

def init_gumbel(gen, n_codes: int, dim: int, in_dim: int,
                dtype=torch.float32, device="cuda"):
    """proj (features -> code logits, the 1x1-conv equivalent) + codebook."""
    device = resolve_device(device)
    proj = torch.empty((in_dim, n_codes), device=device)
    torch.nn.init.trunc_normal_(proj, 0.0, 1.0, -2.0, 2.0, generator=gen)
    e = torch.randn((n_codes, dim), generator=gen, device=device) * 0.02
    return {"proj": {"kernel": (proj * in_dim ** -0.5).to(dtype),
                     "bias": torch.zeros((n_codes,), dtype=dtype,
                                         device=device)},
            "codebook": e.to(dtype)}


def gumbel_quantize(params, z: torch.Tensor,
                    rng: Optional[torch.Generator] = None, temp: float = 1.0,
                    kl_weight: float = 5e-4, hard: bool = True,
                    uniform: Optional[torch.Tensor] = None) -> VQResult:
    """Gumbel-softmax categorical reparameterization (Jang et al. 2016).

    z [..., in_dim] -> logits over codes -> gumbel-softmax sample ->
    z_q = onehot @ codebook (straight-through when ``hard``), plus the
    KL-to-uniform regularizer (quantize_semantic.py:188-190). The noise is
    -log(-log(u)) of ``uniform`` (u in [1e-10, 1), the logits' shape) when
    given, else of draws from ``rng``; with neither, the argmax is
    deterministic (eval)."""
    logits = (z.float() @ params["proj"]["kernel"].float()
              + params["proj"]["bias"].float())
    if uniform is None and rng is not None:
        uniform = 1e-10 + (1.0 - 1e-10) * torch.rand(
            logits.shape, generator=rng, device=logits.device)
    if uniform is not None:
        g = -torch.log(-torch.log(uniform.float()))
        y_soft = torch.softmax((logits + g) / temp, dim=-1)
    else:
        y_soft = torch.softmax(logits / temp, dim=-1)
    idx = y_soft.argmax(dim=-1).to(torch.int32)
    if hard:
        one_hot = F.one_hot(idx.long(), logits.shape[-1]).to(y_soft.dtype)
        y = y_soft + (one_hot - y_soft).detach()      # straight-through
    else:
        y = y_soft
    z_q = (y @ params["codebook"].float()).to(z.dtype)
    qy = torch.softmax(logits, dim=-1)
    n = logits.shape[-1]
    kl = kl_weight * (qy * torch.log(qy * n + 1e-10)).sum(-1).mean()
    return VQResult(z_q, idx, kl)


# ---- EMA codebook (NormEMAVectorQuantizer of the discrete vision model,
#      MultiModalLLM/src/tokenizer/.../quantizer.py:178-231) ----------------

def _l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(eps)


def init_ema_codebook(gen, n_codes: int, dim: int, device="cuda"):
    device = resolve_device(device)
    e = _l2norm(torch.randn((n_codes, dim), generator=gen, device=device))
    return {"codebook": e, "cluster_size": torch.zeros((n_codes,),
                                                       device=device),
            "embed_avg": e.clone()}


def _assign(z: torch.Tensor, indices: torch.Tensor, n_codes: int):
    """Per code: the count of rows assigned to it and their sum."""
    zf = z.reshape(-1, z.shape[-1])
    onehot = F.one_hot(indices.reshape(-1).long(), n_codes).float()
    return onehot.sum(0), onehot.T @ zf


@torch.no_grad()
def ema_update(params, z: torch.Tensor, indices: torch.Tensor,
               decay: float = 0.99, eps: float = 1e-5):
    """One EMA codebook step; returns the new params (the old stay)."""
    n_codes = params["codebook"].shape[0]
    counts, sums = _assign(z.float(), indices, n_codes)
    cluster = decay * params["cluster_size"] + (1 - decay) * counts
    avg = decay * params["embed_avg"] + (1 - decay) * sums
    n = cluster.sum()
    smoothed = (cluster + eps) / (n + n_codes * eps) * n
    return {"codebook": avg / smoothed[:, None], "cluster_size": cluster,
            "embed_avg": avg}


# ---- Norm-EMA quantizer (NormEMAVectorQuantizer, the discrete vision
#      model's codebook: MultiModalLLM/src/tokenizer/.../quantizer.py:239-329)

def norm_ema_quantize(params, z: torch.Tensor, beta: float = 0.25) -> VQResult:
    """Norm-EMA VQ forward (quantizer.py:274-334): z is l2-normalized before
    the nearest-code search; the codebook rows lie on the unit sphere
    (``norm_ema_update`` keeps them there). The only loss is the commitment
    ``beta * mean((sg(z_q) - z)^2)``: the codebook learns by EMA, not by
    gradient. Straight-through on the normalized z."""
    zf = _l2norm(z.float())
    idx = nearest_codes(params["codebook"], zf)
    z_q = params["codebook"][idx.long()].float().detach()
    loss = beta * (z_q - zf).square().mean()
    out = (zf + (z_q - zf).detach()).to(z.dtype)
    return VQResult(out, idx, loss)


@torch.no_grad()
def norm_ema_update(params, z: torch.Tensor, indices: torch.Tensor,
                    decay: float = 0.99, axis_name: Optional[str] = None):
    """Norm-EMA codebook step (quantizer.py:303-325); returns new params.

    Per-code means of the normalized assigned vectors are l2-normalized,
    codes with no assignment keep their row, and the EMA'd weight goes back
    onto the unit sphere (norm_ema_inplace :237-239). ``axis_name`` (a mesh
    axis or a process group) sums bins and sums across its ranks, the
    reference's ``all_reduce_fn`` under DDP."""
    n_codes = params["codebook"].shape[0]
    bins, sums = _assign(_l2norm(z.float()), indices, n_codes)
    if axis_name is not None:
        from ..parallel.comm import psum
        bins, sums = psum(bins, axis_name), psum(sums, axis_name)
    cluster = decay * params["cluster_size"] + (1 - decay) * bins
    zero = bins == 0
    mean = sums / torch.where(zero, torch.ones_like(bins), bins)[:, None]
    target = torch.where(zero[:, None], params["codebook"], _l2norm(mean))
    weight = _l2norm(decay * params["codebook"] + (1 - decay) * target)
    return {"codebook": weight, "cluster_size": cluster,
            "embed_avg": params.get("embed_avg", weight)}


@torch.no_grad()
def kmeans_init_codebook(gen, samples: torch.Tensor, n_codes: int,
                         iters: int = 10,
                         seeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cosine-similarity k-means codebook init (EmbeddingEMA kmeans_init,
    quantizer.py:149-176 + :211-217). samples [N, D] (normalized inside) ->
    unit-norm [n_codes, D] means; an empty cluster keeps its seed. The seed
    rows are ``seeds`` when given, else the first ``n_codes`` of a
    permutation drawn from ``gen`` (uniform draws with replacement when
    N < n_codes)."""
    x = _l2norm(samples.float())
    n = x.shape[0]
    if seeds is None:
        seeds = (torch.randperm(n, generator=gen, device=x.device)[:n_codes]
                 if n >= n_codes else
                 torch.randint(0, n, (n_codes,), generator=gen,
                               device=x.device))
    means = x[seeds.long()]
    for _ in range(iters):
        buckets = (x @ means.T).argmax(dim=-1)
        bins, sums = _assign(x, buckets, n_codes)
        new = _l2norm(sums / bins.clamp_min(1.0)[:, None])
        means = torch.where((bins == 0)[:, None], means, new)
    return means
