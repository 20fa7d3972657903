"""Attention kernels and the ``flash_attention`` dispatcher (counterpart of
seed_tpu/ops/flash_attention.py).

``short_mha`` is the hand-written CUDA kernel that replaces seed_tpu's
``_short_mha_kernel`` (csrc/short_mha.cu): non-causal whole-sequence
attention for the ViT's S=257.

``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` are the hand-written
CUDA kernels (csrc/flash_attention.cu) that replace seed_tpu's
``_flash_kernel``, ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``: the
tiled online-softmax forward (causal with ``q_offset``, ragged kv masked) and
its two backward kernels. ``tiled_flash`` ties them into one differentiable
function, the counterpart of seed_tpu's ``_flash``; LLaMA training
(``forward(use_flash=True)``) is its caller.

Every wrapper runs its plain PyTorch version (``*_plain``: the same
arithmetic, rounding points and tile order) only for a CPU tensor; on a CUDA
tensor it launches the kernel or raises, and counts the launch.

``flash_attention`` keeps seed_tpu's routing: short non-causal calls reach
the short kernel; calls below the kernels' minimum take ``mha``; the exact
branch of a long sequence takes ``mha``; everything else (causal, or long)
takes ``tiled_flash``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import kernels
from .attention import mha, sliced_causal_mask

MIN_FLASH_SEQ = 256   # seed_tpu routing: below this the plain path is taken
MAX_KERNEL_KV = 8192

# epilogues of the kernel (csrc/short_mha.cu `mode`)
EXACT, FAST_ONES, FAST_DIV = 0, 1, 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448   # dynamic shared memory a block may use on the H100
# masked scores of the tiled kernels: large and finite, never -inf
# (exp(-inf - -inf) is NaN); seed_tpu's MASK_VALUE
MASK_VALUE = -0.7 * torch.finfo(torch.float32).max


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


# ------------------------------------------------ tiled flash: rows 3, 4, 5

_FLASH_SIGNATURES = {
    "seed_flash_tile": [ctypes.c_int, ctypes.c_int],
    "seed_flash_fwd": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
    "seed_flash_bwd_dq": ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                          + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float]
                          + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
    "seed_flash_bwd_dkv": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                           + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float]
                           + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
}


def kv_tile(dtype: torch.dtype, head_dim: int) -> int:
    """Rows of the square tile the three kernels of csrc/flash_attention.cu
    walk (``tile_for`` there); the plain versions walk the same tiles so
    that sums and rescalings happen in the same order."""
    if dtype == torch.bfloat16:
        return 64 if head_dim <= 128 else 32
    return 32 if head_dim <= 128 else 16


def _flash_lib(dtype: torch.dtype, head_dim: int):
    lib = kernels.load("flash_attention", _FLASH_SIGNATURES)
    if lib.seed_flash_tile(_DTYPES[dtype], head_dim) != kv_tile(dtype, head_dim):
        raise RuntimeError("flash_attention: the kernel's tile differs from "
                           "kv_tile(); the plain versions no longer mirror it")
    return lib


def _bhsd(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 1, 3).float()


def _tile_mask(rows: torch.Tensor, cols: torch.Tensor, causal: bool,
               kv_len: int) -> torch.Tensor:
    """True where a score is masked: past the kv length, or above the
    diagonal (``rows`` already carry the q offset)."""
    mask = (cols >= kv_len)[None, :].expand(rows.numel(), -1)
    if causal:
        mask = mask | (cols[None, :] > rows[:, None])
    return mask


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, sm_scale: float, q_offset: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch: q [B, Sq, H, D],
    k/v [B, Sk, H, D] -> (o [B, Sq, H, D], lse [B, H, Sq] fp32).

    Online softmax over kv tiles of ``kv_tile`` rows in the kernel's order:
    fp32 scores times the scale; masked scores are MASK_VALUE; fp32 running
    max, sum and accumulator; p rounded to the io type before P@V; output
    ``acc * (1 / l)``. A causal q tile stops at its diagonal tile, and a q
    tile that meets no kv tile gives output 0 and lse 0."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    tile = kv_tile(q.dtype, D)
    dev = q.device
    qf, kf, vf = _bhsd(q), _bhsd(k), _bhsd(v)
    kv_tiles = -(-Sk // tile)
    pad = kv_tiles * tile - Sk      # the kernel's last tile holds zero rows
    if pad:
        kf = torch.nn.functional.pad(kf, (0, 0, 0, pad))
        vf = torch.nn.functional.pad(vf, (0, 0, 0, pad))
    rows = torch.arange(Sq, device=dev)
    if causal:
        last_row = (rows // tile) * tile + tile - 1 + q_offset
        hi = torch.where(last_row < 0, torch.zeros_like(rows),
                         torch.clamp(last_row, min=0) // tile + 1)
    else:
        hi = torch.full_like(rows, kv_tiles)
    m = torch.full((B, H, Sq, 1), float("-inf"), device=dev)
    l = torch.zeros((B, H, Sq, 1), device=dev)
    acc = torch.zeros((B, H, Sq, D), device=dev)
    for j in range(kv_tiles):
        cols = torch.arange(j * tile, (j + 1) * tile, device=dev)
        kt, vt = kf[:, :, cols], vf[:, :, cols]
        s = torch.matmul(qf, kt.transpose(-1, -2)) * sm_scale
        s = s.masked_fill(_tile_mask(rows + q_offset, cols, causal, Sk),
                          MASK_VALUE)
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(s - m_next)
        l_next = alpha * l + p.sum(dim=-1, keepdim=True)
        acc_next = acc * alpha + torch.matmul(p.to(q.dtype).float(), vt)
        met = (j < hi)[None, None, :, None]
        m = torch.where(met, m_next, m)
        l = torch.where(met, l_next, l)
        acc = torch.where(met, acc_next, acc)
    empty = l == 0
    l_inv = torch.where(empty, torch.ones_like(l), 1.0 / l)
    out = (acc * l_inv).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    lse = torch.where(empty, torch.zeros_like(l), m + torch.log(l))
    return out, lse[..., 0].contiguous()


def _bwd_tile_terms(qf, kf, vf, gf, lse, delta, rows, cols, causal, kv_len,
                    sm_scale, dtype):
    """p and ds of one (q rows, kv cols) tile, both rounded to the io type
    as the kernels round them before their products."""
    s = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    s = s.masked_fill(_tile_mask(rows, cols, causal, kv_len), MASK_VALUE)
    p = torch.exp(s - lse)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - delta)
    return p.to(dtype).float(), ds.to(dtype).float()


def flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal: bool,
                       sm_scale: float) -> torch.Tensor:
    """The dq kernel's function in plain PyTorch (no q offset): lse and delta
    fp32 [B, H, Sq]; dq = scale * sum over kv tiles of ds_io @ k, fp32 sums,
    the scale applied once at the end."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    tile = kv_tile(q.dtype, D)
    qf, kf, vf, gf = _bhsd(q), _bhsd(k), _bhsd(v), _bhsd(dout)
    rows = torch.arange(Sq, device=q.device)
    dq = torch.zeros((B, H, Sq, D), device=q.device)
    for c0 in range(0, Sk, tile):
        cols = torch.arange(c0, min(c0 + tile, Sk), device=q.device)
        _, ds = _bwd_tile_terms(qf, kf[:, :, cols], vf[:, :, cols], gf,
                                lse[..., None], delta[..., None], rows, cols,
                                causal, Sk, sm_scale, q.dtype)
        dq = dq + torch.matmul(ds, kf[:, :, cols])
    return (dq * sm_scale).to(q.dtype).permute(0, 2, 1, 3).contiguous()


def flash_bwd_dkv_plain(q, k, v, dout, lse, delta, causal: bool,
                        sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel's function in plain PyTorch (no q offset):
    dv = sum over q tiles of p_io^T @ dO, dk = scale * sum of ds_io^T @ q."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    tile = kv_tile(q.dtype, D)
    qf, kf, vf, gf = _bhsd(q), _bhsd(k), _bhsd(v), _bhsd(dout)
    cols = torch.arange(Sk, device=q.device)
    dk = torch.zeros((B, H, Sk, D), device=q.device)
    dv = torch.zeros((B, H, Sk, D), device=q.device)
    for r0 in range(0, Sq, tile):
        rows = torch.arange(r0, min(r0 + tile, Sq), device=q.device)
        p, ds = _bwd_tile_terms(qf[:, :, rows], kf, vf, gf[:, :, rows],
                                lse[:, :, rows, None], delta[:, :, rows, None],
                                rows, cols, causal, Sk, sm_scale, q.dtype)
        dv = dv + torch.matmul(p.transpose(-1, -2), gf[:, :, rows])
        dk = dk + torch.matmul(ds.transpose(-1, -2), qf[:, :, rows])
    to_io = lambda t: t.to(q.dtype).permute(0, 2, 1, 3).contiguous()
    return to_io(dk * sm_scale), to_io(dv)


def _check_flash(name: str, q, k, v, dout=None, lse=None, delta=None):
    """Raise on anything the kernels of csrc/flash_attention.cu do not take;
    returns (dims, strides array, vec flag)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if q.dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {q.dtype} not supported "
                         "(float32 or bfloat16)")
    if not 1 <= D <= 256:
        raise ValueError(f"{name}: head dim {D} outside 1..256")
    if min(B, Sq, Sk, H) < 1 or max(B, H) > 65535:
        raise ValueError(f"{name}: shape {tuple(q.shape)} x kv {Sk} not "
                         "launchable")
    tensors = [("k", k, (B, Sk, H, D)), ("v", v, (B, Sk, H, D))]
    if dout is not None:
        tensors.append(("dout", dout, (B, Sq, H, D)))
    for label, t, shape in tensors:
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: {label} must match q's device and dtype")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {label} shape {tuple(t.shape)} != {shape}")
    staged = [q] + [t for _, t, _ in tensors]
    if any(t.stride(3) != 1 for t in staged):
        raise ValueError(f"{name}: q/k/v/dout need a unit stride on the head dim")
    for label, t in (("lse", lse), ("delta", delta)):
        if t is None:
            continue
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != (B, H, Sq) or not t.is_contiguous()):
            raise ValueError(f"{name}: {label} must be contiguous fp32 "
                             f"[B, H, Sq] on q's device")
    flat = [s for t in staged for s in t.stride()[:3]]
    strides = (ctypes.c_longlong * len(flat))(*flat)
    vec = int(q.dtype == torch.bfloat16 and D % 8 == 0
              and all(s % 8 == 0 for s in flat)
              and all(t.data_ptr() % 16 == 0 for t in staged))
    return (B, Sq, Sk, H, D), strides, vec


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
              sm_scale: float, q_offset: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tiled flash forward: q [B, Sq, H, D], k/v [B, Sk, H, D] (any strides
    with a unit stride on D, same head count) -> (o contiguous [B, Sq, H, D],
    lse fp32 [B, H, Sq]). Row i attends to columns <= i + q_offset when
    ``causal``.

    CPU tensors take :func:`flash_fwd_plain`; CUDA tensors launch the forward
    kernel of csrc/flash_attention.cu or raise."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, sm_scale, q_offset)
    (B, Sq, Sk, H, D), strides, vec = _check_flash("flash_fwd", q, k, v)
    lib = _flash_lib(q.dtype, D)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.seed_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, Sq, Sk, H, D, strides, float(sm_scale),
            int(causal), int(q_offset), vec, _DTYPES[q.dtype], stream)
    kernels.check(err, "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool,
                 sm_scale: float) -> torch.Tensor:
    """dq of the tiled flash attention (no q offset) -> contiguous
    [B, Sq, H, D]. ``lse`` is the forward's, ``delta = rowsum(dO * O)`` in
    fp32, both [B, H, Sq].

    CPU tensors take :func:`flash_bwd_dq_plain`; CUDA tensors launch the dq
    kernel of csrc/flash_attention.cu or raise."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal, sm_scale)
    (B, Sq, Sk, H, D), strides, vec = _check_flash(
        "flash_bwd_dq", q, k, v, dout, lse, delta)
    lib = _flash_lib(q.dtype, D)
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.seed_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, Sq, Sk, H, D,
            strides, float(sm_scale), int(causal), vec, _DTYPES[q.dtype],
            stream)
    kernels.check(err, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal: bool,
                  sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk and dv of the tiled flash attention (no q offset) -> two contiguous
    [B, Sk, H, D] tensors. One block per kv tile walks the q tiles, so there
    are no atomics and results repeat from run to run.

    CPU tensors take :func:`flash_bwd_dkv_plain`; CUDA tensors launch the
    dk/dv kernel of csrc/flash_attention.cu or raise."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, dout, lse, delta, causal, sm_scale)
    (B, Sq, Sk, H, D), strides, vec = _check_flash(
        "flash_bwd_dkv", q, k, v, dout, lse, delta)
    lib = _flash_lib(q.dtype, D)
    dk = torch.empty((B, Sk, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, Sk, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.seed_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, Sq, Sk, H, D, strides, float(sm_scale), int(causal), vec,
            _DTYPES[q.dtype], stream)
    kernels.check(err, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


class _TiledFlash(torch.autograd.Function):
    """Forward kernel, with the dq and dk/dv kernels as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, q_offset):
        out, lse = flash_fwd(q, k, v, causal, sm_scale, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.flash_args = (causal, sm_scale, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, sm_scale, q_offset = ctx.flash_args
        if q_offset != 0:
            # seed_tpu's rule: the backward kernels carry no q offset (their
            # causal bounds assume row i meets column i), so a chunked call
            # recomputes its gradient through the plain mha path
            with torch.enable_grad():
                qkv = [t.detach().requires_grad_() for t in (q, k, v)]
                mask = (sliced_causal_mask(q.shape[1], k.shape[1], q_offset,
                                           q.device) if causal else None)
                ref = mha(*qkv, mask=mask, scale=sm_scale)
                grads = torch.autograd.grad(ref, qkv, dout)
            return (*grads, None, None, None)
        if dout.stride(3) != 1:
            dout = dout.contiguous()
        # delta_i = sum_d dO_id * O_id in fp32: a plain op, as in seed_tpu
        delta = (dout.float() * out.float()).sum(dim=-1)
        delta = delta.permute(0, 2, 1).contiguous()
        dq = flash_bwd_dq(q, k, v, dout, lse, delta, causal, sm_scale)
        dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, causal, sm_scale)
        return dq, dk, dv, None, None, None


def tiled_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, sm_scale: float, q_offset: int = 0
                ) -> torch.Tensor:
    """Differentiable tiled flash attention on [B, S, H, D] tensors with
    equal head counts (seed_tpu's ``_flash``): the forward kernel, and in
    ``backward`` the dq and dk/dv kernels."""
    return _TiledFlash.apply(q, k, v, causal, sm_scale, q_offset)


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

    return tiled_flash(q, k, v, causal, scale, q_offset)
