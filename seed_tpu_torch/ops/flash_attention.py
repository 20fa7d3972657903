"""Short-sequence attention kernel and the ``flash_attention`` dispatcher
(counterpart of seed_tpu/ops/flash_attention.py).

``short_mha`` is the hand-written CUDA kernel that replaces seed_tpu's
``_short_mha_kernel`` (csrc/short_mha.cu): non-causal whole-sequence
attention for the ViT's S=257. On a CPU tensor it runs ``short_mha_plain``,
the same arithmetic in plain PyTorch with the TPU kernel's op order; on a
CUDA tensor it launches the kernel or raises.

``flash_attention`` keeps seed_tpu's routing: the same calls reach the
short kernel; calls below the kernel's minimum take ``mha``; the exact branch
of a long sequence takes ``mha``. The tiled causal flash kernel
(``_flash_kernel``, ROADMAP kernel row 3) is not ported yet, so its branch
raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import kernels
from .attention import mha, sliced_causal_mask

MIN_FLASH_SEQ = 256   # seed_tpu routing: below this the plain path is taken
MAX_KERNEL_KV = 8192

# epilogues of the kernel (csrc/short_mha.cu `mode`)
EXACT, FAST_ONES, FAST_DIV = 0, 1, 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448   # dynamic shared memory a block may use on the H100


_SIGNATURES = {
    "seed_short_mha": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 14
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p]),
    "seed_short_mha_smem_bytes": [ctypes.c_int, ctypes.c_int],
}


def _lib():
    return kernels.load("short_mha", _SIGNATURES)


def _mode(exact: bool, head_dim: int) -> int:
    if exact:
        return EXACT
    return FAST_ONES if head_dim % 128 != 0 else FAST_DIV


def short_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float, exact: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch, q/k/v [B, S, H, D] -> [B, Sq, H, D].

    Op order of seed_tpu's ``_short_mha_kernel``: fp32 scores times the
    scale, one-pass max and exp, then the epilogue —
    exact: normalise the fp32 p, round to the io type, then P@V;
    fast with D % 128 != 0: l is the fp32 sum of the io-rounded p (the TPU's
    ones column); fast otherwise: l is the fp32 sum of the unrounded p.
    P@V accumulates in fp32 (upcast io values multiply exactly)."""
    qt, kt, vt = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    s = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) * sm_scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    if exact:
        pn = (p / p.sum(dim=-1, keepdim=True)).to(v.dtype)
        o = torch.matmul(pn.float(), vt.float())
    else:
        pio = p.to(v.dtype)
        ones_column = _mode(exact, q.shape[-1]) == FAST_ONES
        l = (pio.float() if ones_column else p).sum(dim=-1, keepdim=True)
        o = torch.matmul(pio.float(), vt.float()) / l
    return o.to(q.dtype).permute(0, 2, 1, 3).contiguous()


def short_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              sm_scale: float, exact: bool = False) -> torch.Tensor:
    """Non-causal attention over a whole short sequence, q/k/v [B, S, H, D]
    (any strides with a unit stride on D) -> contiguous [B, Sq, H, D].

    CPU tensors take :func:`short_mha_plain`; CUDA tensors launch the
    kernel of csrc/short_mha.cu or raise."""
    if q.device.type == "cpu":
        return short_mha_plain(q, k, v, sm_scale, exact)
    if q.device.type != "cuda":
        raise ValueError(f"short_mha: unsupported device {q.device}")
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"short_mha: {name} must match q's device and dtype")
        if t.shape != (B, Sk, H, D):
            raise ValueError(f"short_mha: {name} shape {tuple(t.shape)} != "
                             f"{(B, Sk, H, D)}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"short_mha: dtype {q.dtype} not supported "
                         "(float32 or bfloat16)")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("short_mha: q/k/v need a unit stride on the head dim")
    if max(abs(s) for t in (q, k, v) for s in t.stride()) >= 2 ** 31:
        raise ValueError("short_mha: strides do not fit in 32 bits")
    if not 1 <= D <= 256:
        raise ValueError(f"short_mha: head dim {D} outside 1..256")
    lib = _lib()
    if lib.seed_short_mha_smem_bytes(Sk, D) > SMEM_LIMIT:
        raise ValueError(f"short_mha: Sk={Sk}, D={D} needs more shared memory "
                         "than a block has")
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.seed_short_mha(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, H, D, q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(sm_scale), _mode(exact, D), _DTYPES[q.dtype], stream)
    kernels.check(err, "short_mha")
    short_mha.launches += 1
    return out


short_mha.launches = 0


def _short_vmem_bytes(Sq, Sk, H, D, itemsize=2):
    """seed_tpu's VMEM estimate of one _short_mha program; kept so the port
    routes exactly the calls seed_tpu routes to the short kernel."""
    sp = lambda s: -(-s // 16) * 16
    lp = lambda d: -(-d // 128) * 128
    blocks = H * (sp(Sq) + 2 * sp(Sk) + sp(Sq)) * lp(D) * itemsize * 2
    scores = sp(Sq) * lp(Sk) * 4 * 3
    return blocks + scores


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    q_offset: int = 0, exact: bool = False) -> torch.Tensor:
    """Attention on [B, S, H, D] tensors with seed_tpu's kernel routing. GQA
    supported. Short non-causal sequences take the ``short_mha`` kernel."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    h_kv = k.shape[2]
    if h_kv != H:
        rep = H // h_kv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)

    rnd128 = lambda s: -(-s // 128) * 128
    kv_vmem = rnd128(Sk) * rnd128(D) * 2 * 2 * 2
    use_kernel = (Sq >= MIN_FLASH_SEQ and Sk >= MIN_FLASH_SEQ
                  and D <= 256 and Sk <= MAX_KERNEL_KV
                  and kv_vmem <= 12 * 1024 * 1024)
    if not use_kernel:
        mask = (sliced_causal_mask(Sq, Sk, q_offset, q.device)
                if causal else None)
        return mha(q, k, v, mask=mask, scale=scale)

    if (not causal and Sq <= 1024 and Sk <= 1024
            and _short_vmem_bytes(Sq, Sk, H, D) < 12 * 1024 * 1024):
        return short_mha(q, k, v, scale, exact)

    if exact:
        # only the short kernel has the op-faithful epilogue; seed_tpu takes
        # the plain path here too
        mask = (sliced_causal_mask(Sq, Sk, q_offset, q.device)
                if causal else None)
        return mha(q, k, v, mask=mask, scale=scale)

    raise NotImplementedError(
        "flash_attention: the tiled (causal or long-sequence) flash kernel, "
        "seed_tpu/ops/flash_attention.py::_flash_kernel, is not ported yet "
        "(ROADMAP.md, TPU kernels still to port, row 3)")
