"""Attention kernels and the ``flash_attention`` dispatcher (counterpart of
seed_tpu/ops/flash_attention.py).

``short_mha`` is the hand-written CUDA kernel that replaces seed_tpu's
``_short_mha_kernel`` (csrc/short_mha.cu): non-causal whole-sequence
attention for the ViT's S=257. Its gradient recomputes through ``mha``, the
rule of seed_tpu's ``_short_mha`` custom_vjp. ``exact_attention`` is the
ViT's default attention: ``mha``'s arithmetic, run by the kernel's exact
epilogue for the bf16 CUDA calls ``short_exact_route`` admits.
``unmasked_attention`` is the UNet's: the tiled flash forward (below) for
the bf16 CUDA calls ``tiled_route`` admits, ``mha`` for the rest.

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
# the bf16 forward's base-2 scores (csrc/flash_attention.cu kLog2e, kLn2)
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


_SIGNATURES = {
    "seed_short_mha": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 14
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p]),
    "seed_short_mha_smem_bytes": [ctypes.c_int] * 3,
    "seed_short_mha_f32_plan": [ctypes.c_int] * 4,
    "seed_short_mha_bf16_one_pass": [ctypes.c_int] * 3,
}

# the fp32 kernel's tiles (csrc/short_mha.cu kF32*): rows come in groups of
# 16, a tile takes at most 4 groups; a two-stage ring of K slabs (144 keys x
# 16 columns) or V slabs (32 keys x the padded head dim)
F32_GROUP, F32_MAX_GROUPS = 16, 4
F32_K_STAGE_FLOATS, F32_V_KEYS = 144 * 16, 32


def _lib():
    return kernels.load("short_mha", _SIGNATURES)


def _padded_head_dim(head_dim: int) -> int:
    """The head dims the kernels are built for (``sm90::padded_head_dim``)."""
    return next((d for d in (32, 64, 96, 128, 192) if head_dim <= d), 256)


def _f32_smem_bytes(groups: int, sk: int, head_dim: int) -> int:
    """``f32_smem_bytes``: the two ring stages, then per row Q (the head
    dim rounded up to 8, plus 4), the scores (Sk rounded up to 4, plus 4
    where that is a multiple of 8) and the row sum."""
    stage = max(F32_K_STAGE_FLOATS, F32_V_KEYS * _padded_head_dim(head_dim))
    ld_q = -(-head_dim // 8) * 8 + 4
    ld_s = -(-sk // 4) * 4
    ld_s += 4 if ld_s % 8 == 0 else 0
    return 4 * (2 * stage + F32_GROUP * groups * (ld_q + ld_s + 1))


def short_mha_f32_plan(sq: int, sk: int, head_dim: int) -> Tuple[int, int]:
    """(rows of the largest tile, its shared memory in bytes) of the fp32
    kernel (``f32_groups_per_tile`` in csrc/short_mha.cu): the most row
    groups of 16, up to 4, whose shared memory fits a block (one when none
    does: the wrapper then refuses the call), and no more than Sq has."""
    groups = F32_MAX_GROUPS
    while groups > 1 and _f32_smem_bytes(groups, sk, head_dim) > SMEM_LIMIT:
        groups -= 1
    groups = min(groups, -(-sq // F32_GROUP))
    return F32_GROUP * groups, _f32_smem_bytes(groups, sk, head_dim)


def short_mha_f32_tiles(sq: int, rows: int) -> list:
    """(first row, rows) of each tile the fp32 kernel launches: the
    ceil(Sq / 16) row groups dealt out over ceil(groups / (rows / 16))
    tiles, the first ones taking one group more where they do not divide."""
    groups, per = -(-sq // F32_GROUP), rows // F32_GROUP
    n = -(-groups // per)
    base, extra = divmod(groups, n)
    tiles, g = [], 0
    for t in range(n):
        take = base + (t < extra)
        tiles.append((F32_GROUP * g, min(F32_GROUP * take, sq - F32_GROUP * g)))
        g += take
    return tiles


_F32_PLANS_CHECKED = set()


def _check_f32_plan(lib, sq: int, sk: int, head_dim: int) -> None:
    """Raise if the library's fp32 plan differs from ``short_mha_f32_plan``
    at this shape (once per shape and loaded library)."""
    key = (lib, sq, sk, head_dim)
    if key in _F32_PLANS_CHECKED:
        return
    rows, smem = short_mha_f32_plan(sq, sk, head_dim)
    tiles = len(short_mha_f32_tiles(sq, rows))
    got = tuple(lib.seed_short_mha_f32_plan(sq, sk, head_dim, i) for i in range(3))
    if got != (rows, smem, tiles):
        raise RuntimeError(f"short_mha: the fp32 kernel's plan {got} differs "
                           f"from short_mha_f32_plan's {(rows, smem, tiles)}; "
                           "the mirror is stale")
    _F32_PLANS_CHECKED.add(key)


def _mode(exact: bool, head_dim: int) -> int:
    if exact:
        return EXACT
    return FAST_ONES if head_dim % 128 != 0 else FAST_DIV


def _vec(q: torch.Tensor, staged) -> int:
    """1 when a kernel may stage 16 bytes (8 bf16 or 4 fp32 elements) at a
    time: the head dim, every row, batch and head stride and every base
    address are multiples of 16 bytes."""
    n = 16 // q.element_size()
    return int(q.dtype in (torch.bfloat16, torch.float32) and q.shape[-1] % n == 0
               and all(s % n == 0 for t in staged for s in t.stride()[:3])
               and all(t.data_ptr() % 16 == 0 for t in staged))


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


def _short_mha_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       sm_scale: float, exact: bool) -> torch.Tensor:
    """The forward of :func:`short_mha`: the plain version for a CPU tensor,
    the kernel for a CUDA tensor (counted in ``short_mha.launches``)."""
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
    if lib.seed_short_mha_smem_bytes(Sk, D, _DTYPES[q.dtype]) > SMEM_LIMIT:
        raise ValueError(f"short_mha: Sk={Sk}, D={D} needs more shared memory "
                         "than a block has")
    if q.dtype == torch.float32:
        _check_f32_plan(lib, Sq, Sk, D)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.seed_short_mha(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, H, D, q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(sm_scale), _mode(exact, D), _vec(q, (q, k, v)),
            _DTYPES[q.dtype], stream)
    kernels.check(err, "short_mha")
    short_mha.launches += 1
    return out


class _ShortMHA(torch.autograd.Function):
    """The short kernel (its plain version on the CPU) with seed_tpu's
    ``_short_mha`` gradient rule: the backward recomputes through ``mha``."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, exact):
        ctx.save_for_backward(q, k, v)
        ctx.sm_scale = sm_scale
        return _short_mha_forward(q, k, v, sm_scale, exact)

    @staticmethod
    def backward(ctx, dout):
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            ref = mha(*qkv, scale=ctx.sm_scale)
            grads = torch.autograd.grad(ref, qkv, dout)
        return (*grads, None, None)


def short_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              sm_scale: float, exact: bool = False) -> torch.Tensor:
    """Non-causal attention over a whole short sequence, q/k/v [B, S, H, D]
    (any strides with a unit stride on D) -> contiguous [B, Sq, H, D].
    Differentiable: the gradient recomputes through ``mha``, as seed_tpu's
    ``_short_mha`` does.

    CPU tensors take :func:`short_mha_plain`; CUDA tensors launch the
    kernel of csrc/short_mha.cu (bf16: wgmma with a row's scores in
    registers, one pass, where Sk <= 264 and 33 <= D <= 96, else mma.sync
    with the scores recomputed per pass; fp32: register-tiled
    products on the FMA units, tiles by :func:`short_mha_f32_plan`) or
    raise."""
    return _ShortMHA.apply(q, k, v, sm_scale, exact)


short_mha.launches = 0


# ------------------------------------------------ tiled flash: rows 3, 4, 5

_FLASH_SIGNATURES = {
    "seed_flash_tile": [ctypes.c_int] * 3,
    "seed_flash_smem_bytes": [ctypes.c_int] * 3,
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


def fwd_tiles(dtype: torch.dtype, head_dim: int) -> Tuple[int, int]:
    """(q tile, kv tile) rows of the forward kernel (``tile_rows`` 0 and 1
    in csrc/flash_attention.cu). Both io types: 64 q rows (4 warps of 16).
    bf16: kv tiles of 64 rows up to D = 128 and 32 above, where the register
    accumulator leaves room for half the score tile; fp32: kv tiles of 32
    rows (``kF32KvTile``: fp32 tiles take twice the shared memory).
    :func:`flash_fwd_plain` rescales at the same kv tile boundaries and stops
    a causal q tile where the kernel does."""
    if dtype == torch.bfloat16:
        return 64, (64 if head_dim <= 128 else 32)
    return 64, 32


def bwd_tiles(dtype: torch.dtype, head_dim: int
              ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((q rows, kv tile) of the dq kernel, (kv rows, q tile) of the dk/dv
    kernel) (``tile_rows`` 2-5 in csrc/flash_attention.cu). bf16: blocks own
    64 rows; dq streams kv tiles of 64 rows up to D = 128 and 32 above (the
    dQ accumulator takes the registers), dk/dv streams q tiles of 64 rows up
    to D = 64 and 32 above (dK and dV take them). fp32: dq blocks own 64 q
    rows over kv tiles of 16 rows (``kF32DqKvTile``), dk/dv blocks 64 kv
    rows over q tiles of 16 rows (``kF32QTile``), at every D: two blocks an
    SM up to D = 128. The plain versions sum in these tiles' order and stop
    where the kernels' causal bounds do."""
    if dtype == torch.bfloat16:
        return (64, 64 if head_dim <= 128 else 32), (64, 64 if head_dim <= 64 else 32)
    return (64, 16), (64, 16)


def _flash_lib(dtype: torch.dtype, head_dim: int):
    lib = kernels.load("flash_attention", _FLASH_SIGNATURES)
    rows = [lib.seed_flash_tile(_DTYPES[dtype], head_dim, i) for i in range(6)]
    kernel = (tuple(rows[:2]), (tuple(rows[2:4]), tuple(rows[4:])))
    if kernel != (fwd_tiles(dtype, head_dim), bwd_tiles(dtype, head_dim)):
        raise RuntimeError(f"flash_attention: the kernel's tiles {kernel} differ "
                           "from fwd_tiles() / bwd_tiles(); the plain versions "
                           "no longer mirror them")
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


def _base2(dtype: torch.dtype, sm_scale: float, device):
    """Score scale and exponential of the kernels: the bf16 kernels work in
    base 2 (scores times the fp32 product ``scale * log2(e)``, exp2), the
    fp32 kernels in base e."""
    if dtype != torch.bfloat16:
        return sm_scale, torch.exp, False
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    return f32(sm_scale) * f32(LOG2E), torch.exp2, True


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, sm_scale: float, q_offset: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch: q [B, Sq, H, D],
    k/v [B, Sk, H, D] -> (o [B, Sq, H, D], lse [B, H, Sq] fp32).

    Online softmax over the kernel's kv tiles (:func:`fwd_tiles`) in its
    order: fp32 scores times the scale; masked scores are MASK_VALUE; fp32
    running max, sum and accumulator; p rounded to the io type before P@V;
    output ``acc * (1 / l)``. bf16 keeps the scores in base 2, as the kernel
    does: s times ``scale * log2(e)`` (an fp32 product), p = exp2(s - m) and
    lse = m * ln 2 + log(l). A causal q tile stops at the kv tile holding its
    last row's diagonal, and a q tile that meets no kv tile gives output 0
    and lse 0."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    q_tile, tile = fwd_tiles(q.dtype, D)
    dev = q.device
    scale, exp, base2 = _base2(q.dtype, sm_scale, dev)
    qf, kf, vf = _bhsd(q), _bhsd(k), _bhsd(v)
    kv_tiles = -(-Sk // tile)
    pad = kv_tiles * tile - Sk      # the kernel's last tile holds zero rows
    if pad:
        kf = torch.nn.functional.pad(kf, (0, 0, 0, pad))
        vf = torch.nn.functional.pad(vf, (0, 0, 0, pad))
    rows = torch.arange(Sq, device=dev)
    if causal:
        last_row = (rows // q_tile) * q_tile + q_tile - 1 + q_offset
        hi = torch.where(last_row < 0, torch.zeros_like(rows),
                         torch.clamp(last_row // tile + 1, max=kv_tiles))
    else:
        hi = torch.full_like(rows, kv_tiles)
    m = torch.full((B, H, Sq, 1), float("-inf"), device=dev)
    l = torch.zeros((B, H, Sq, 1), device=dev)
    acc = torch.zeros((B, H, Sq, D), device=dev)
    for j in range(kv_tiles):
        cols = torch.arange(j * tile, (j + 1) * tile, device=dev)
        kt, vt = kf[:, :, cols], vf[:, :, cols]
        s = torch.matmul(qf, kt.transpose(-1, -2)) * scale
        s = s.masked_fill(_tile_mask(rows + q_offset, cols, causal, Sk),
                          MASK_VALUE)
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = exp(m - m_next)
        p = exp(s - m_next)
        l_next = alpha * l + p.sum(dim=-1, keepdim=True)
        acc_next = acc * alpha + torch.matmul(p.to(q.dtype).float(), vt)
        met = (j < hi)[None, None, :, None]
        m = torch.where(met, m_next, m)
        l = torch.where(met, l_next, l)
        acc = torch.where(met, acc_next, acc)
    empty = l == 0
    l_inv = torch.where(empty, torch.ones_like(l), 1.0 / l)
    out = (acc * l_inv).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    ln2 = torch.tensor(LN2, dtype=torch.float32, device=dev)
    lse = (m * ln2 if base2 else m) + torch.log(l)
    lse = torch.where(empty, torch.zeros_like(l), lse)
    return out, lse[..., 0].contiguous()


def _bwd_tile_terms(qf, kf, vf, gf, lse, delta, rows, cols, causal, kv_len,
                    scale, exp, dtype):
    """p and ds of one (q rows, kv cols) tile, both rounded to the io type
    as the kernels round them before their products. ``lse`` is already in
    the base of ``exp``."""
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    s = s.masked_fill(_tile_mask(rows, cols, causal, kv_len), MASK_VALUE)
    p = exp(s - lse)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - delta)
    return p.to(dtype).float(), ds.to(dtype).float()


def _bwd_inputs(q, k, v, dout, lse, sm_scale):
    """[B, H, S, D] fp32 views, the score scale, the exponential and lse in
    its base (bf16: lse * log2(e), an fp32 product)."""
    scale, exp, base2 = _base2(q.dtype, sm_scale, q.device)
    if base2:
        lse = lse * torch.tensor(LOG2E, dtype=torch.float32, device=q.device)
    return (_bhsd(q), _bhsd(k), _bhsd(v), _bhsd(dout)), scale, exp, lse


def flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal: bool,
                       sm_scale: float) -> torch.Tensor:
    """The dq kernel's function in plain PyTorch (no q offset): lse and delta
    fp32 [B, H, Sq]; dq = scale * sum over the kernel's kv tiles
    (:func:`bwd_tiles`) of ds_io @ k, fp32 sums, the scale applied once at
    the end. A causal q tile stops at the kv tile holding its last row's
    diagonal."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    (q_tile, tile), _ = bwd_tiles(q.dtype, D)
    (qf, kf, vf, gf), scale, exp, lse = _bwd_inputs(q, k, v, dout, lse, sm_scale)
    rows = torch.arange(Sq, device=q.device)
    kv_tiles = -(-Sk // tile)
    hi = ((rows // q_tile) * q_tile + q_tile - 1) // tile + 1 if causal else kv_tiles
    dq = torch.zeros((B, H, Sq, D), device=q.device)
    for j in range(kv_tiles):
        cols = torch.arange(j * tile, min((j + 1) * tile, Sk), device=q.device)
        _, ds = _bwd_tile_terms(qf, kf[:, :, cols], vf[:, :, cols], gf,
                                lse[..., None], delta[..., None], rows, cols,
                                causal, Sk, scale, exp, q.dtype)
        met = torch.as_tensor(j < hi, device=q.device)
        dq = torch.where(met[..., None], dq + torch.matmul(ds, kf[:, :, cols]), dq)
    return (dq * sm_scale).to(q.dtype).permute(0, 2, 1, 3).contiguous()


def flash_bwd_dkv_plain(q, k, v, dout, lse, delta, causal: bool,
                        sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel's function in plain PyTorch (no q offset):
    dv = sum over the kernel's q tiles (:func:`bwd_tiles`) of p_io^T @ dO,
    dk = scale * sum of ds_io^T @ q. Under causal masking a kv tile starts at
    the q tile whose last row reaches its first column."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    _, (kv_tile, q_tile) = bwd_tiles(q.dtype, D)
    (qf, kf, vf, gf), scale, exp, lse = _bwd_inputs(q, k, v, dout, lse, sm_scale)
    cols = torch.arange(Sk, device=q.device)
    lo = (cols // kv_tile) * kv_tile // q_tile if causal else torch.zeros_like(cols)
    dk = torch.zeros((B, H, Sk, D), device=q.device)
    dv = torch.zeros((B, H, Sk, D), device=q.device)
    for i, r0 in enumerate(range(0, Sq, q_tile)):
        rows = torch.arange(r0, min(r0 + q_tile, Sq), device=q.device)
        p, ds = _bwd_tile_terms(qf[:, :, rows], kf, vf, gf[:, :, rows],
                                lse[:, :, rows, None], delta[:, :, rows, None],
                                rows, cols, causal, Sk, scale, exp, q.dtype)
        met = (i >= lo)[:, None]
        dv = torch.where(met, dv + torch.matmul(p.transpose(-1, -2), gf[:, :, rows]), dv)
        dk = torch.where(met, dk + torch.matmul(ds.transpose(-1, -2), qf[:, :, rows]), dk)
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
    return (B, Sq, Sk, H, D), strides, _vec(q, staged)


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
    flash_fwd.launches_f32 += q.dtype == torch.float32
    return out, lse


flash_fwd.launches = 0
flash_fwd.launches_f32 = 0       # of them, the fp32 forward kernel


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
    flash_bwd_dq.launches_f32 += q.dtype == torch.float32
    return dq


flash_bwd_dq.launches = 0
flash_bwd_dq.launches_f32 = 0       # of them, the fp32 kernel


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
    flash_bwd_dkv.launches_f32 += q.dtype == torch.float32
    return dk, dv


flash_bwd_dkv.launches = 0
flash_bwd_dkv.launches_f32 = 0       # of them, the fp32 kernel


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


def _long_enough(Sq: int, Sk: int, D: int) -> bool:
    """Both lengths from MIN_FLASH_SEQ, D up to 256."""
    return Sq >= MIN_FLASH_SEQ and Sk >= MIN_FLASH_SEQ and D <= 256


def _kernel_sized(Sq: int, Sk: int, D: int) -> bool:
    """seed_tpu's condition for any attention kernel: ``_long_enough``, K
    and V within its VMEM estimate."""
    rnd128 = lambda s: -(-s // 128) * 128
    kv_vmem = rnd128(Sk) * rnd128(D) * 2 * 2 * 2
    return (_long_enough(Sq, Sk, D) and Sk <= MAX_KERNEL_KV
            and kv_vmem <= 12 * 1024 * 1024)


def _short_sized(Sq: int, Sk: int, H: int, D: int) -> bool:
    """seed_tpu's condition for the short kernel, given a kernel-sized
    non-causal call: both lengths up to 1024, one program within VMEM."""
    return (Sq <= 1024 and Sk <= 1024
            and _short_vmem_bytes(Sq, Sk, H, D) < 12 * 1024 * 1024)


def _card_bf16_same_heads(q: torch.Tensor, k: torch.Tensor) -> bool:
    """q a bf16 CUDA tensor (not a DTensor) and k with q's head count."""
    from ..parallel.local import is_sharded
    return (q.device.type == "cuda" and q.dtype == torch.bfloat16
            and k.shape[2] == q.shape[2] and not is_sharded(q))


def short_exact_route(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether :func:`exact_attention` sends a non-causal, unmasked call to
    the short kernel, decided from q and k alone: a bf16 CUDA tensor (not a
    DTensor) with k's head count, at lengths ``flash_attention`` routes to
    ``short_mha``."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    return (_card_bf16_same_heads(q, k) and _kernel_sized(Sq, Sk, D)
            and _short_sized(Sq, Sk, H, D))


def exact_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Non-causal, unmasked attention with ``mha``'s arithmetic on [B, S, H,
    D] tensors: fp32 scores times D ** -0.5, the softmax against each row's
    max in fp32, p rounded to the io type, P@V in fp32 rounded once. Where
    :func:`short_exact_route` says so it runs ``short_mha``'s exact epilogue,
    which has these rounding points; every other call runs ``mha``."""
    if short_exact_route(q, k):
        return short_mha(q, k, v, q.shape[-1] ** -0.5, exact=True)
    return mha(q, k, v)


def tiled_route(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether :func:`unmasked_attention` sends a non-causal, unmasked call
    to the tiled flash forward, decided from q and k alone: a bf16 CUDA
    tensor (not a DTensor) with k's head count, both lengths from
    MIN_FLASH_SEQ and D up to 256. There is no cap on Sk: seed_tpu's
    MAX_KERNEL_KV and VMEM estimate bound a Pallas kernel that holds K and V
    resident, while the CUDA forward streams 64-row K/V tiles through a
    two-stage ring whose shared memory does not grow with Sk. The length
    floor is seed_tpu's routing threshold, kept as it is: the card has timed
    the forward against ``mha`` at 576 tokens and at 144 (``chip_smoke.py``,
    phase 2), at nothing in between."""
    return (_card_bf16_same_heads(q, k)
            and _long_enough(q.shape[1], k.shape[1], q.shape[3]))


def unmasked_attention(q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """Non-causal, unmasked attention on [B, S, H, D] tensors at scale
    D ** -0.5. Where :func:`tiled_route` says so it runs ``tiled_flash``:
    fp32 scores in base 2, fp32 running max, sum and accumulator, p rounded
    to bf16 before P@V and the output rounded once (the online softmax of
    ``scaled_dot_product_attention``); every other call runs ``mha``."""
    if tiled_route(q, k):
        return tiled_flash(q, k, v, False, q.shape[-1] ** -0.5)
    return mha(q, k, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    q_offset: int = 0, exact: bool = False) -> torch.Tensor:
    """Attention on [B, S, H, D] tensors with seed_tpu's kernel routing. GQA
    supported. Short non-causal sequences take the ``short_mha`` kernel.
    DTensors (a model sharded over a mesh) run on their local rows and
    heads (``parallel.local.on_local_shards``)."""
    from ..parallel.local import is_sharded, on_local_shards
    if is_sharded(q):
        return on_local_shards(flash_attention, q, k, v, causal=causal,
                               scale=scale, q_offset=q_offset, exact=exact)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    h_kv = k.shape[2]
    if h_kv != H:
        rep = H // h_kv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)

    if not _kernel_sized(Sq, Sk, D):
        mask = (sliced_causal_mask(Sq, Sk, q_offset, q.device)
                if causal else None)
        return mha(q, k, v, mask=mask, scale=scale)

    if not causal and _short_sized(Sq, Sk, H, D):
        return short_mha(q, k, v, scale, exact)

    if exact:
        # only the short kernel has the op-faithful epilogue; seed_tpu takes
        # the plain path here too
        mask = (sliced_causal_mask(Sq, Sk, q_offset, q.device)
                if causal else None)
        return mha(q, k, v, mask=mask, scale=scale)

    return tiled_flash(q, k, v, causal, scale, q_offset)
