"""Drive the PyTorch port (seed_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing lines of its own:

1. build   — compile the five CUDA sources of seed_tpu_torch/csrc/ (one nvcc
             per source, all at once) into build/seed_tpu_torch/; a spill in
             any tensor-core kernel, in short_mha's fp32 kernel or in the
             GroupNorm kernels fails the run.
2. kernels — hold each of the six kernels (short_mha, int8_matmul, the tiled
             flash forward, dq and dk/dv, and w8a8_matmul) against its plain
             PyTorch version on the card at the main paths' shapes, and time
             kernel, plain version, the library yardstick and the bound
             (int8_matmul also against cuBLAS on a pre-converted weight;
             short_mha at B=8 and at the b256 encode's B=256, which is the
             kernels line's row 1); int8_matmul and w8a8_matmul repeat their bits at every case;
             short_mha's gradient (the mha recompute) against mha. The
             flash forward also at the UNet's self-attention (non-causal,
             B=2, D=64: 9,216 x 5, 2,304 x 10 and 576 x 20 heads, routed
             by flash_attention.unmasked_attention, and the mid block's 144
             x 20, which is not), timed in bf16 beside its bound, mha (the
             plain path the UNet takes elsewhere) and the library. The fp32
             instances off every path, int8_matmul with fp32 x (M=256,
             K=N=4096; two TF32 products against the exact int8 weight) and
             the fp32 flash forward, dq and dk/dv (split TF32; dq and dk/dv
             bit for bit over two calls) at B=1, S=1024, H=32, D=128,
             causal, are timed beside their bounds, plain versions and
             library calls, and their launches after this phase are
             counted; one fp32 autograd step at SEED-LLaMA-8B's width cut to
             2 layers through train_llm.llm_loss launches all three against
             plain mha. The GroupNorm kernel (the port's own, no TPU
             counterpart) at the UNet's largest input (CFG batch 2 at 96x96
             x 960) and the VAE's 768x768 x 256, with and without SiLU,
             against the plain fp32 chain and bit for bit over two calls,
             timed with SiLU beside its byte bound, the plain chain with its
             SiLU pass (the path before it) and F.group_norm + F.silu.
3. reference — the full-width fp32 encode through the short_mha kernel
             against the same encode through the plain mha path.
4. encode  — full SEED tokenizer (EVA-ViT-g, 39 blocks), seeded bf16 weights:
             8 uint8 images -> preprocess -> 32 ids each, the default
             config (mha's arithmetic through short_mha's exact epilogue),
             flash exact and fast; 39 short_mha launches an encode; the
             default config's ids equal flash exact's bit for bit.
5. serve   — SEED-LLaMA-8B, seeded bf16 weights quantized to int8 layer by
             layer, built by instantiate(load_config(
             "configs/seed_llama_8b_8bit.json")): batched
             LlamaEngine.generate and SeedLlamaInterface requests, greedy
             and sampled.
6. server  — the throughput server on the same 8B int8 weights: the W8A8
             encoder (quantize_for_serving + serving_fast_config: 156
             w8a8_matmul launches per encode); a ScheduledEngine with 16 fp8
             slots, a registered 256-token prefix and 24 requests from 4
             threads; the /generate HTTP service on an ephemeral port; the
             fp8 and int8 ring caches and a num_beams=5 request through
             LlamaEngine.
7. train   — SEED-LLaMA-8B (32 layers, bf16, seeded weights) + LoRA r=16
             through Trainer: grad_accum 2 x micro-batch 4 x 1024 tokens,
             per-layer recompute, causal attention of every layer through the
             flash forward, dq and dk/dv kernels; AdamW, cosine schedule with
             warm-up; three steps, a saved state, and a fourth step from a
             fresh trainer that restored it.
8. detokenize — the SD2.1 unCLIP de-tokenizer (UNet + VAE, seeded weights),
             run after phase 6 on its objects (phase 6's /generate service
             already has it attached): one UNet pass in bf16 against fp32
             (the bf16 pass launches the flash forward 15 times, the
             self-attention of levels 0-2, and the GroupNorm kernel 61
             times); encode -> 8B int8 generate (force_image) -> a valid
             image block appended -> SeedLlamaInterface.split_output ->
             768x768 pixels through the offloaded bf16 decoder (20 DDIM
             steps, guidance 10, 300 flash forward launches, 1,250
             GroupNorm launches: 61 a UNet pass, 30 in the VAE) -> PNG; the
             same decode in fp32 against bf16.
9. train_llm — python3 -m seed_tpu_torch.train.train_llm on pkl tar shards
             written under build/: SEED-LLaMA-8B + LoRA through the flash
             kernels (--batch-size 8 --grad-accum 2 --max-length 1024), 4
             steps with saves at 2 and 4, then a fresh main(--resume) for
             step 5 and one caption eval round on the merged weights.
10. train_tokenizer — python3 -m seed_tpu_torch.train.train_tokenizer on a
             JPEG + caption tar: stage 1 at full width (frozen fp32
             EVA-ViT-g through the fp32 short_mha kernel, Q-Former with its
             text pathway, batch 16, 3 steps, saved), then stage 2 from that
             checkpoint with the random CLIP-ViT-H targets computed inline
             (2 steps; the bf16 tower's attention also runs short_mha, 32
             launches a batch the data thread prepares); short_mha's fp32
             launch at that shape timed, with
             the fast epilogue the path runs and the exact one.
11. eval   — 11a (after phase 8, on its objects): reconstruction FID and
             IS of the de-tokenizer's pixels (the 8 images encoded, decoded
             to 768x768, Inception-v3 pool3 against the originals; IS over
             the logits), Inception fp32 on the card against the CPU and in
             bf16; 11b: evaluate_vqa over a VQA jsonl and 8 JPEGs written
             under build/, through SEED-LLaMA-8B int8 (one batched prefill of
             8 prompts); 11c (after phase 10): the Q-Former caption
             generators, recompute and cached, on phase 10's stage-1
             checkpoint, 16 images, scored with caption_metrics; 11d: the
             discrete vision model at DVMConfig() on the frozen CLIP-ViT-H
             tower (3 timed Trainer steps, a fourth under profile_trace), then its
             CLIP-embed variant with a k-means-initialised norm-EMA codebook.
             11c and 11d log through MetricLogger and time with StepTimer.
12. parallel — 12a: a one-rank NCCL process group (FileStore under build/)
             and make_mesh(1, 1, 1, 1): train_llm --tp 1 on phase 9's shards
             and seed goes through the mesh Trainer (DTensor state laid out
             by LLAMA_TP_RULES), 4 steps through the flash kernels, the first
             loss against phase 9's, the save at step 4 restored bit for bit
             into a Trainer without a mesh, the median ms of steps 2-4 beside
             phase 9's; ring attention and pipeline_forward at the 8B layer's
             shapes against mha and the unpipelined layers. 12b: python3 -m
             seed_tpu_torch.data.extract_image_ids (SEED_TOKENIZER bf16,
             --batch-size 16) on 160 JPEGs made as phase 10's through the
             loader native.available() chose: img/s over all and over the
             batches after the first, its ids against the same encode in
             process, the shards read back into a caption example. Only one
             card: NCCL does not put two ranks on one GPU, so the multi-rank
             semantics are held on the CPU (tests/test_torch_parallel*.py).
13. scripts — the five command lines of seed_tpu_torch/scripts/ in process
             through their main(): seed_llama_inference --model 8b (bf16,
             32 layers, the full SEED tokenizer, the three prompts sampled,
             64 new tokens each, then 1 for the prefill's seconds) on a JPEG
             written under build/; seed_tokenizer_inference with a seeded
             bf16 SD2.1 unCLIP checkpoint it writes (a 768x768 JPEG, ids
             against SeedLlamaInterface.encode_image of the same bytes);
             merge_lora at the 8B's width cut to 4 layers (MERGE_LAYERS)
             against merge_lora_weights in memory; acceptance --synthetic
             --device cuda (exit 0); check_full_geometry for the 8B and 14B,
             LoRA and --full, at --tp 2 --devices=8. short_mha launches 39
             times for each of their 9 bf16 encodes; seed_tokenizer_inference's
             bf16 decode runs its UNet pass eagerly twice (a CUDA graph's
             warm-up and capture; the replays are not counted) and its VAE
             once: the flash forward 30 times, the GroupNorm kernel 152
             times; acceptance's TINY decoder (bf16 latents) the GroupNorm
             kernel 78 times (2 x 21 in its UNet, 2 x 18 in its VAE); no
             other kernel runs.

Phases 4-5 (serving), phase 6 (the throughput server), phase 7 (training),
phase 9 (train_llm), phase 10 (train_tokenizer), phases 11a-11b (eval) and
phase 12a (parallel) are the main paths: the launch counters of a path's kernels are set to 0
just before it and read just after. Phase 8 launches only the flash
forward and the GroupNorm kernel (the bf16 UNet and VAE; the GroupNorm
kernel's launches there are its path's count) and phase 13 only short_mha,
the flash forward and the GroupNorm kernel (its bf16 encodes and decode;
the lines show the counts); the rest of phase 8 and phase 13 is counted on
no path; nor are 11c
and 11d (11c's frozen EVA-ViT-g launches short_mha fp32, uncounted).
Every failure raises, so the script exits non-zero and prints no result line.
The last line is the device record; the line before it lists the kernels, the
one before that the card.
"""
from __future__ import annotations

import base64
import dataclasses
import io
import json
import math
import pickle
import re
import statistics
import subprocess
import sys
import tarfile
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12             # dense bf16 tensor-core peak
FP32_FLOPS = 67e12              # fp32 outside the tensor cores
TF32_FLOPS = 495e12             # dense TF32 tensor-core peak
INT8_OPS = 1979e12              # dense int8 tensor-core peak
PEAK_FLOPS = {torch.bfloat16: BF16_FLOPS, torch.float32: FP32_FLOPS}
SEED = 0


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# device cycles the card idles before each timed call (~0.1 ms), long
# enough for the host to enqueue the call behind it
HOST_COVER_CYCLES = 200_000


def time_ms(fn, iters: int = 10, flush: torch.Tensor = None,
            hide_host: bool = True) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events), after
    one warm-up call; ``flush`` is overwritten before each call so the inputs
    come from device memory, not from the 50 MB L2, as they do on the path.
    With ``hide_host`` the device idles (``torch.cuda._sleep``) before the
    start event while the host prepares the call, so the interval holds the
    call's device work and not the wrapper's Python time; without it (the
    method of PRs 1-3) a call whose host time exceeds the flush's counts
    the difference."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        if hide_host:
            torch.cuda._sleep(HOST_COVER_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def split_tf32_bounds(nbytes: float, flops: float, products: int) -> dict:
    """The bound of an fp32 kernel whose products run as split TF32 on the
    tensor cores, the card's fastest fp32-accurate products: ``products``
    TF32 products for each fp32 one (three; two where one operand is an
    int8 weight, a TF32 value exactly) at the TF32 peak. The same fp32
    operations on the FMA units are kept apart as ``bound_fp32_fma_ms``."""
    bms, by = bound_ms(nbytes, products * flops, TF32_FLOPS)
    return dict(bound_ms=bms, bound_by=by,
                bound_fp32_fma_ms=bound_ms(nbytes, flops, FP32_FLOPS)[0])


# --------------------------------------------------------------- phase 1

# the redesigned kernels of rows 1-6, by their functions' names (row 2 also
# its split-K reduction and its fp32-x kernel; row 1 its fp32 instance on
# the FMA units apart; rows 3-5 their fp32 instances on split-TF32 products
# apart)
PTXAS_KERNELS = {"short_mha": ("short_mha_wg_kernel",),
                 "short_mha_recompute": ("short_mha_bf16_kernel",),
                 "short_mha_f32": ("short_mha_f32_kernel",),
                 "flash_fwd": ("flash_fwd_bf16_kernel",),
                 "flash_fwd_f32": ("flash_fwd_f32_kernel",),
                 "flash_bwd_dq": ("flash_bwd_dq_bf16_kernel",),
                 "flash_bwd_dq_f32": ("flash_bwd_dq_f32_kernel",),
                 "flash_bwd_dkv": ("flash_bwd_dkv_bf16_kernel",),
                 "flash_bwd_dkv_f32": ("flash_bwd_dkv_f32_kernel",),
                 "int8_matmul": ("int8_mm_bf16", "int8_mm_reduce", "int8_mm_f32"),
                 "w8a8_matmul": ("w8a8_mm",),
                 "group_norm": ("gn_stats_kernel", "gn_apply_kernel"),
                 "group_norm_resident": ("gn_resident_kernel",)}


def _instance(fn: str, mangled: str):
    """The instance key of kernel function ``fn`` in a mangled entry name:
    its integer template arguments joined by "/" (Dp for the flash kernels,
    "Dp/mode" for short_mha, "warps_m/warps_n/m16 tiles/slabs/out type" for
    w8a8_mm, U for gn_stats_kernel, "U/silu" for gn_apply_kernel and
    "bytes/silu" for gn_resident_kernel), or the function's name when it is
    no template; None when the entry is another function."""
    m = re.search(fn + r"(?:I((?:Li\d+E)+)(13__nv_bfloat16|f)?E)?", mangled)
    if m is None:
        return None
    if m.group(1) is None:
        return fn
    key = "/".join(re.findall(r"Li(\d+)E", m.group(1)))
    if m.group(2):
        key += "/bf16" if "bfloat16" in m.group(2) else "/f32"
    return key


def ptxas_usage(reports: dict) -> dict:
    """Registers and spill bytes nvcc reported for each instance of the
    tensor-core kernels of rows 1-6: {kernel: {instance: {registers,
    spill_stores, spill_loads}}}, the instance as :func:`_instance` names it;
    empty for a library not built in this run."""
    usage, current = {}, None
    for log in reports.values():
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '([^']+)'", line)
            if entry:
                current = None
                for kernel, fns in PTXAS_KERNELS.items():
                    for fn in fns:
                        key = _instance(fn, entry.group(1))
                        if key is not None:
                            current = usage.setdefault(kernel, {}).setdefault(key, {})
                continue
            if current is None:
                continue
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                              line)
            if spill:
                current["spill_stores"] = int(spill.group(1))
                current["spill_loads"] = int(spill.group(2))
            regs = re.search(r"Used (\d+) registers", line)
            if regs:
                current["registers"] = int(regs.group(1))
    return usage


def spill_bytes(use: dict):
    """Spill stores plus loads of one instance; None when it was not built."""
    if not use:
        return None
    return use.get("spill_stores", 0) + use.get("spill_loads", 0)


def phase_build(name: str) -> dict:
    """Build every kernel source; returns ptxas_usage() of the build. The
    redesigned tensor-core kernels must not spill."""
    from seed_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    reports = kernels.build()
    seconds = time.perf_counter() - t0
    for kernel, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  nvcc {kernel}: {line.strip()}")
    usage = ptxas_usage(reports)
    for kernel, per_dp in usage.items():
        for dp, use in per_dp.items():
            if use.get("spill_stores") or use.get("spill_loads"):
                raise AssertionError(f"{kernel} (Dp={dp}) spills registers: {use}")
    emit("build", seconds=seconds, built=sorted(reports), ptxas=usage, card=name)
    return usage


# --------------------------------------------------------------- phase 2

def _qkv_views(gen, B, S, H, D, dtype):
    """q/k/v as strided views of one fused [B, S, 3*H*D] tensor, as the ViT
    block hands them to the kernel."""
    qkv = torch.randn(B, S, 3 * H * D, generator=gen, device="cuda").to(dtype)
    return tuple(t.reshape(B, S, H, D) for t in qkv.split(H * D, dim=-1))


def phase_kernels(name: str, flush: torch.Tensor) -> dict:
    """Kernel row 1 against its plain version, and short_mha's gradient.
    Returns the per-kernel record (errors and times at the main path's
    shape) for the final kernels line."""
    import torch.nn.functional as F
    from seed_tpu_torch.ops.flash_attention import short_mha, short_mha_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    record = {}

    # short_mha: EVA-ViT-g shape at B=8, both io types, all three epilogues
    # (D=88 -> exact and fast-with-ones; D=128 -> fast-divide), timed; the
    # b256 encode's call (B=256: one block walks a (b, h)'s five q tiles),
    # bf16 exact and fast, timed; then D=64 and the longest sequence the
    # dispatcher routes here (Sk = 1024), checked only.
    # Tolerance: fp32 2e-5 (sum order only); bf16 2**-6 (a bf16 rounding of
    # p or of the output may land one ulp apart when sums differ in order).
    tol = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -6}
    both, bf16 = (torch.bfloat16, torch.float32), (torch.bfloat16,)
    cases = [(8, 257, 16, D, exact, True, both) for D, exact in
             ((88, True), (88, False), (128, True), (128, False))]
    cases += [(256, 257, 16, 88, exact, True, bf16) for exact in (True, False)]
    cases += [(8, 257, 16, 64, True, False, both),
              (2, 1024, 16, 88, True, False, both),
              (2, 1024, 16, 88, False, False, both)]
    worst, row1 = 0.0, {}
    for B, S, H, D, exact, timed, dtypes in cases:
        for dtype in dtypes:
            q, k, v = _qkv_views(gen, B, S, H, D, dtype)
            scale = D ** -0.5
            got = short_mha(q, k, v, scale, exact)
            want = short_mha_plain(q, k, v, scale, exact)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            same = (got == want).float().mean().item()
            label = dict(B=B, S=S, H=H, D=D, exact=exact,
                         dtype=str(dtype).split(".")[-1])
            if not err <= tol[dtype]:
                raise AssertionError(f"short_mha {label}: max_abs_err {err} > "
                                     f"{tol[dtype]}")
            worst = max(worst, err)
            if not timed:
                emit("kernels", kernel="short_mha", **label, max_abs_err=err,
                     frac_equal=same, tol=tol[dtype], card=name)
                continue
            del got, want
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            ms = time_ms(lambda: short_mha(q, k, v, scale, exact), flush=flush)
            plain = time_ms(lambda: short_mha_plain(q, k, v, scale, exact),
                            flush=flush)
            lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                          flush=flush)
            del qt, kt, vt
            nbytes = 4 * B * S * H * D * dtype.itemsize
            flops = 4 * B * H * S * S * D
            bms, by = bound_ms(nbytes, flops, PEAK_FLOPS[dtype])
            timing = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                          bound_by=by)
            if dtype == torch.bfloat16 and D == 88 and exact:
                # an exact encode's call; also timed as PRs 1-3 timed it
                timing["ms_host_included"] = time_ms(
                    lambda: short_mha(q, k, v, scale, exact), flush=flush,
                    hide_host=False)
                row1[B] = dict(timing)
            emit("kernels", kernel="short_mha", **label, max_abs_err=err,
                 frac_equal=same, tol=tol[dtype], card=name, **timing)
    # the kernels line's row 1: the b256 encode's call, the main path's
    # shape, with the B=8 call beside it
    record["short_mha"] = dict(row1[256], b8=row1[8], max_abs_err=worst)

    # short_mha's gradient on the card: one call through flash_attention's
    # short route with requires_grad (the kernel forward, the mha recompute
    # backward) against the port's mha autograd, fp32, 3e-3 (seed_tpu's bound)
    from seed_tpu_torch.ops.attention import mha
    from seed_tpu_torch.ops.flash_attention import flash_attention
    leaves = [torch.randn(1, 257, 2, 88, generator=gen, device="cuda")
              .requires_grad_() for _ in range(3)]
    refs = [t.detach().clone().requires_grad_() for t in leaves]
    dout = torch.randn(1, 257, 2, 88, generator=gen, device="cuda")
    before = short_mha.launches
    flash_attention(*leaves).backward(dout)
    mha(*refs).backward(dout)
    if short_mha.launches != before + 1:
        raise AssertionError("short_mha gradient: the forward did not launch "
                             "the kernel")
    errs = [(t.grad - r.grad).abs().max().item() for t, r in zip(leaves, refs)]
    if not max(errs) <= 3e-3:
        raise AssertionError(f"short_mha gradient: max_abs_err {errs}")
    emit("kernels", kernel="short_mha", what="dq, dk, dv through "
         "flash_attention's short route vs mha autograd, fp32, B=1 S=257 H=2 "
         "D=88", max_abs_err=dict(zip(("dq", "dk", "dv"), errs)), tol=3e-3,
         card=name)
    return record


def _repeat_bits(kernel: str, label: dict, run, first) -> None:
    """A second call on the same inputs gives the same bits, or raise."""
    if not torch.equal(run(), first):
        raise AssertionError(f"{kernel} {label}: a second call on the same "
                             "inputs gave other bits")


# M of the 8B prefill in phase 11b: 8 VQA prompts padded to bucket 256
VQA_PREFILL_M = 8 * 256


def phase_int8_kernel(name: str, flush: torch.Tensor, usage: dict) -> dict:
    """Kernel row 2 against its plain version: the four (K, N) pairs of the
    8B prefill at M = 4 x 64 (phase 3) and at VQA_PREFILL_M (phase 11b, no
    split, several waves), bf16 x, and 4096 x 4096 at M = 512 (the
    scheduler's bucket); a ragged M; fp32 x at 4096 x 4096 (split), 11008 x
    4096 (split, the longest K) and 4096 x 40320 with a ragged M (unsplit).
    Every case is repeated bit for bit and timed beside the plain version,
    two library yardsticks and the bound (fp32 also as two TF32 products).
    Tolerance, relative to max|y|: bf16 2**-7 (one output rounding apart),
    fp32 1e-5 (sum order and x's split residue, within 2**-22 a product)."""
    from seed_tpu_torch.ops.int8_matmul import (int8_matmul, int8_matmul_plain,
                                                int8_plan, _SIGNATURES)
    from seed_tpu_torch.ops import kernels
    from seed_tpu_torch.ops.quantization import quantize_weight

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    lib8 = kernels.load("int8_matmul", _SIGNATURES)
    smem = {dtype: lib8.seed_int8_matmul_smem_bytes(code)
            for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1))}
    built = usage.get("int8_matmul", {})
    per_prefill = {(4096, 4096): 4 * 32, (4096, 11008): 2 * 32,
                   (11008, 4096): 32, (4096, 40320): 1}
    worst = 0.0
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, gemm_ms=0.0)
    ops_total = bytes_total = 0.0
    cases = [(M, K, N, torch.bfloat16) for M in (256, VQA_PREFILL_M)
             for (K, N) in per_prefill]
    cases += [(512, 4096, 4096, torch.bfloat16), (300, 4096, 11008, torch.bfloat16),
              (256, 4096, 4096, torch.float32), (256, 11008, 4096, torch.float32),
              (300, 4096, 40320, torch.float32)]
    for M, K, N, dtype in cases:
        w = torch.randn(K, N, generator=gen, device="cuda") * 0.02
        qw = quantize_weight(w)
        del w
        x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
        wq, sc = qw["kernel_q"], qw["scale"]
        label = dict(M=M, K=K, N=N, dtype=str(dtype).split(".")[-1])
        got = int8_matmul(x, wq, sc)
        want = int8_matmul_plain(x, wq, sc)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        limit = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
        if not rel <= limit:
            raise AssertionError(f"int8_matmul {label}: relative error {rel} "
                                 f"> {limit}")
        _repeat_bits("int8_matmul", label, lambda: int8_matmul(x, wq, sc), got)
        worst = max(worst, err)
        ms = time_ms(lambda: int8_matmul(x, wq, sc), flush=flush)
        plain = time_ms(lambda: int8_matmul_plain(x, wq, sc), flush=flush)
        lib = time_ms(lambda: x @ wq.to(x.dtype) * sc, flush=flush)
        # the GEMM alone, on a weight converted before the timing: a kernel
        # whose dequant cost nothing
        wx = wq.to(x.dtype)
        gemm = time_ms(lambda: x @ wx, flush=flush)
        del wx
        nbytes = M * K * dtype.itemsize + K * N + N * 4 + M * N * dtype.itemsize
        flops = 2 * M * N * K
        bf16 = dtype == torch.bfloat16
        # fp32 x: two TF32 products (x's hi and lo halves) at the TF32 peak
        bounds = (dict(zip(("bound_ms", "bound_by"),
                           bound_ms(nbytes, flops, BF16_FLOPS)))
                  if bf16 else split_tf32_bounds(nbytes, flops, 2))
        in_prefill = dtype == torch.bfloat16 and M in (256, VQA_PREFILL_M)
        n = per_prefill.get((K, N), 0) if in_prefill else 0
        # the record averages phase 3's prefill; 11b's is reported per case
        serve = n if M == 256 else 0
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("gemm_ms", gemm)):
            tot[key] += serve * val
        bytes_total += serve * nbytes
        ops_total += serve * flops
        plan = int8_plan(M, N, K, dtype)
        main = built.get("int8_mm_bf16" if bf16 else "int8_mm_f32", {})
        kernel = dict(registers=main.get("registers"),
                      spill_bytes=spill_bytes(main), smem_bytes=smem[dtype])
        if not bf16 and (M, K, N) == (256, 4096, 4096):
            fp32_x = dict(shape=dict(M=M, K=K, N=N, dtype="float32"), ms=ms,
                          plain_ms=plain, library_ms=lib, gemm_ms=gemm,
                          **bounds, max_abs_err=err, rel_err=rel, plan=plan,
                          kernel=dict(name="int8_mm_f32", **kernel))
        emit("kernels", kernel="int8_matmul", **label, plan=plan,
             max_abs_err=err, rel_err=rel, tol_rel=limit, repeats_bits=True,
             launches_per_prefill=n, prefill=("phase 3 serve" if M == 256
                                              else "phase 11b VQA")
             if n else None, card=name, ms=ms, plain_ms=plain,
             library_ms=lib, library="x @ w.to(x.dtype) * scale",
             gemm_ms=gemm, gemm="x @ w.to(x.dtype), converted before the timing",
             **bounds, tflops=flops / ms * 1e-9, **kernel,
             reduce_registers=built.get("int8_mm_reduce", {}).get("registers")
             if plan[2] > 1 else None)
        del qw, x, got, want
    # the record is per launch, averaged over one prefill's mix of shapes
    n = sum(per_prefill.values())
    bms, by = bound_ms(bytes_total / n, ops_total / n, BF16_FLOPS)
    record = {key: val / n for key, val in tot.items()}
    record.update(bound_ms=bms, bound_by=by, max_abs_err=worst)
    emit("kernels", kernel="int8_matmul", summary="mean per launch over one "
         "8B prefill at M = 256 (phase 3, 225 launches)", card=name, **record)
    # the fp32-x instance (int8_mm_f32), on no path
    record["fp32_x"] = fp32_x
    return {"int8_matmul": record}


# ------------------------------------------------- phase 2, kernel rows 3-5

# Tolerances of the flash kernels against their plain versions (same tiles,
# same rounding points). Forward: fp32 differs by the order of fp32 sums and
# by the split-TF32 products of the fp32 forward and dk/dv kernels (within
# 3 * 2**-22 of |a b| a product: scores of O(1) move by about 1e-6), 2e-5;
# bf16 by an output rounding that lands one ulp apart at |o| < 4 (2**-6);
# lse is fp32 either way (2e-5). Backward: sums of up to S products of O(1)
# terms; fp32 1e-4 absolute; bf16 roundings of p and ds one ulp apart, 2**-5
# of the largest gradient.
FLASH_FWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -6}
FLASH_LSE_TOL = 2e-5
FLASH_BWD_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (0.0, 2.0 ** -5)}
# (B, Sq, Sk, H, D, causal, q_offset, timed): the training shape; a ragged
# causal one at D=64; the non-causal ViT shape (kv masking); a chunk at an
# offset (forward only: its gradient takes the mha recompute); D=256 (the
# bf16 forward's and dq's 32-row kv tiles, dk/dv's split columns) with Sq
# not a multiple of the 64-row blocks; a ragged chunk at an offset at D=64;
# D=36 (element-wise staging) with S a multiple of no tile; S=4096, twice
# the 8B's max_seq_len (dk/dv summing over 256 q tiles, dq over 256 kv tiles);
# the UNet's self-attention at CFG batch 2 (forward only, as the de-tokenizer
# runs it): levels 0-2 over 9,216, 2,304 and 576 tokens, the forward's route,
# and the mid block's 144, below MIN_FLASH_SEQ and so on mha. The last field:
# "train" timed with the backward, "check" fwd and bwd checked only, "unet"
# the forward checked (also against mha) and timed in bf16 beside mha.
FLASH_CASES = [(4, 1024, 1024, 32, 128, True, 0, "train"),
               (2, 300, 300, 4, 64, True, 0, "check"),
               (2, 257, 257, 4, 88, False, 0, "check"),
               (2, 256, 512, 4, 128, True, 256, "check"),
               (2, 333, 333, 4, 256, True, 0, "check"),
               (1, 190, 450, 4, 64, True, 260, "check"),
               (2, 100, 100, 4, 36, True, 0, "check"),
               (1, 4096, 4096, 4, 128, True, 0, "check"),
               (2, 9216, 9216, 5, 64, False, 0, "unet"),
               (2, 2304, 2304, 10, 64, False, 0, "unet"),
               (2, 576, 576, 20, 64, False, 0, "unet"),
               (2, 144, 144, 20, 64, False, 0, "unet")]


def _pairs(Sq, Sk, causal, q_offset):
    """(row, column) pairs the attention covers."""
    if not causal:
        return Sq * Sk
    return sum(min(Sk, max(0, r + q_offset + 1)) for r in range(Sq))


def phase_flash_kernels(name: str, flush: torch.Tensor) -> dict:
    """Kernel rows 3-5 against their plain versions; times at the training
    shape in bf16 (the record) and fp32, and the dq + dk/dv pair against the
    library's whole backward; the forward at the UNet's shapes against mha
    and the library (the record's ``unet``)."""
    import torch.nn.functional as F
    from seed_tpu_torch.ops import flash_attention as TF
    from seed_tpu_torch.ops.attention import mha, sliced_causal_mask

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    record = {}
    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    unet = []
    for B, Sq, Sk, H, D, causal, off, mode in FLASH_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            mk = lambda S: torch.randn(B, S, H, D, generator=gen,
                                       device="cuda").to(dtype)
            q, k, v, dout = mk(Sq), mk(Sk), mk(Sk), mk(Sq)
            scale = D ** -0.5
            label = dict(B=B, Sq=Sq, Sk=Sk, H=H, D=D, causal=causal,
                         q_offset=off, dtype=str(dtype).split(".")[-1])
            out, lse = TF.flash_fwd(q, k, v, causal, scale, off)
            want, want_lse = TF.flash_fwd_plain(q, k, v, causal, scale, off)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            lse_err = (lse - want_lse).abs().max().item()
            if not (err <= FLASH_FWD_TOL[dtype] and lse_err <= FLASH_LSE_TOL):
                raise AssertionError(f"flash_fwd {label}: max_abs_err {err}, "
                                     f"lse {lse_err}")
            worst["flash_fwd"] = max(worst["flash_fwd"], err)
            errs = {"flash_fwd": err, "lse": lse_err}
            if mode == "unet":
                if dtype == torch.bfloat16:
                    unet.append(_flash_unet_case(TF, mha, q, k, v, out, label,
                                                 flush, name))
                else:
                    emit("kernels", kernel="flash_fwd", **label,
                         max_abs_err=errs, card=name)
                del q, k, v, dout, out, lse, want, want_lse
                torch.cuda.empty_cache()
                continue
            if off == 0:
                delta = (dout.float() * want.float()).sum(-1)
                delta = delta.permute(0, 2, 1).contiguous()
                args = (q, k, v, dout, want_lse, delta, causal, scale)
                dq = TF.flash_bwd_dq(*args)
                dk, dv = TF.flash_bwd_dkv(*args)
                if dtype == torch.float32:    # no atomics: the same bits
                    again = (TF.flash_bwd_dq(*args), *TF.flash_bwd_dkv(*args))
                    torch.cuda.synchronize()
                    if not all(map(torch.equal, (dq, dk, dv), again)):
                        raise AssertionError(f"flash_bwd_dq / flash_bwd_dkv "
                                             f"{label}: two calls differ")
                    del again
                want_dq = TF.flash_bwd_dq_plain(*args)
                want_dk, want_dv = TF.flash_bwd_dkv_plain(*args)
                torch.cuda.synchronize()
                atol, rtol = FLASH_BWD_TOL[dtype]
                for kern, got, ref in (("flash_bwd_dq", dq, want_dq),
                                       ("flash_bwd_dkv", dk, want_dk),
                                       ("flash_bwd_dkv", dv, want_dv)):
                    e = (got.float() - ref.float()).abs().max().item()
                    if not e <= atol + rtol * ref.float().abs().max().item():
                        raise AssertionError(f"{kern} {label}: max_abs_err {e}")
                    worst[kern] = max(worst[kern], e)
                    errs[kern] = max(errs.get(kern, 0.0), e)
            if mode == "check":
                emit("kernels", kernel="flash", **label, max_abs_err=errs,
                     card=name)
                continue

            # times at the training shape. Operations: 2*D per (row, column)
            # pair and matrix product: 2 products forward (QK^T, PV), 3 in dq
            # (QK^T, dO V^T, dS K), 4 in dk/dv (QK^T, dO V^T, P^T dO, dS^T Q).
            # Bytes: every input read once, every output written once.
            iters = 10 if dtype == torch.bfloat16 else 3
            pairs = B * H * _pairs(Sq, Sk, causal, off)
            tensor = B * Sq * H * D * dtype.itemsize
            rowvec = B * H * Sq * 4
            work = {"flash_fwd": (2 * 2 * D * pairs, 4 * tensor + rowvec),
                    "flash_bwd_dq": (3 * 2 * D * pairs, 5 * tensor + 2 * rowvec),
                    "flash_bwd_dkv": (4 * 2 * D * pairs, 6 * tensor + 2 * rowvec)}
            qt, kt, vt, gt = (t.transpose(1, 2).contiguous().requires_grad_()
                              for t in (q, k, v, dout))
            sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
            lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), iters, flush)
            # one autograd call computes dq, dk and dv together
            lib_bwd = time_ms(lambda: torch.autograd.grad(
                sdpa, (qt, kt, vt), gt, retain_graph=True), iters, flush)
            runs = {
                "flash_fwd": (lambda: TF.flash_fwd(q, k, v, causal, scale),
                              lambda: TF.flash_fwd_plain(q, k, v, causal, scale),
                              lib_fwd),
                "flash_bwd_dq": (lambda: TF.flash_bwd_dq(*args),
                                 lambda: TF.flash_bwd_dq_plain(*args), lib_bwd),
                "flash_bwd_dkv": (lambda: TF.flash_bwd_dkv(*args),
                                  lambda: TF.flash_bwd_dkv_plain(*args), lib_bwd),
            }
            for kern, (fn, plain_fn, lib) in runs.items():
                flops, nbytes = work[kern]
                # fp32: every product as three TF32 products
                bounds = (dict(zip(("bound_ms", "bound_by"),
                                   bound_ms(nbytes, flops, BF16_FLOPS)))
                          if dtype == torch.bfloat16
                          else split_tf32_bounds(nbytes, flops, 3))
                timing = dict(ms=time_ms(fn, iters, flush),
                              plain_ms=time_ms(plain_fn, 2, flush),
                              library_ms=lib, **bounds)
                if dtype == torch.bfloat16 and kern == "flash_fwd":
                    # also timed as PRs 1-3 timed it
                    timing["ms_host_included"] = time_ms(fn, iters, flush,
                                                         hide_host=False)
                if dtype == torch.bfloat16:
                    record[kern] = dict(timing)
                emit("kernels", kernel=kern, **label, max_abs_err=errs[kern],
                     flops=flops, bytes=nbytes, card=name,
                     library="scaled_dot_product_attention(is_causal=True)"
                     + ("" if kern == "flash_fwd" else
                        " backward, dq+dk+dv in one call"), **timing)
            # the pair against the library's whole backward
            pair = time_ms(lambda: (TF.flash_bwd_dq(*args),
                                    TF.flash_bwd_dkv(*args)), iters, flush)
            flops = work["flash_bwd_dq"][0] + work["flash_bwd_dkv"][0]
            emit("kernels", kernel="flash_bwd_dq+flash_bwd_dkv", **label,
                 ms=pair, library_ms=lib_bwd, ratio_to_library=pair / lib_bwd,
                 tflops=flops / pair * 1e-9, card=name,
                 library="scaled_dot_product_attention(is_causal=True) "
                 "backward, dq+dk+dv in one call")
            del qt, kt, vt, gt, sdpa

    # the fp32 forward (split TF32) at the training layer's shape, B=1:
    # against its plain version, timed beside SDPA in fp32 (CUTLASS's
    # memory-efficient kernel); bound as three TF32 products at the TF32
    # tensor-core peak, and the fp32 FMA units' apart
    B, S, H, D = 1, 1024, 32, 128
    q, k, v = (torch.randn(B, S, H, D, generator=gen, device="cuda")
               for _ in range(3))
    out, _ = TF.flash_fwd(q, k, v, True, D ** -0.5)
    want, want_lse = TF.flash_fwd_plain(q, k, v, True, D ** -0.5)
    err = (out - want).abs().max().item()
    if not err <= FLASH_FWD_TOL[torch.float32]:
        raise AssertionError(f"flash_fwd fp32 B=1: max_abs_err {err}")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pairs = B * H * _pairs(S, S, True, 0)
    nbytes = 4 * B * S * H * D * 4 + B * H * S * 4
    fp32 = dict(shape=dict(B=B, S=S, H=H, D=D, causal=True, dtype="float32"),
                ms=time_ms(lambda: TF.flash_fwd(q, k, v, True, D ** -0.5), 10,
                           flush),
                plain_ms=time_ms(lambda: TF.flash_fwd_plain(q, k, v, True,
                                                            D ** -0.5), 2, flush),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True), 10, flush),
                **split_tf32_bounds(nbytes, 2 * 2 * D * pairs, 3),
                max_abs_err=err)
    emit("kernels", kernel="flash_fwd", what="the fp32 forward at B=1",
         library="scaled_dot_product_attention(is_causal=True), fp32",
         card=name, **fp32)
    del out, qt, kt, vt

    # the fp32 dq and dk/dv kernels (split TF32) at the same shape: against
    # their plain versions and bit for bit over two calls, timed beside
    # SDPA's fp32 backward (dq, dk and dv in one call), alone and as a pair;
    # operations as the bf16 rows count them, bound as three TF32 products
    # each, the fp32 FMA units' apart
    dout = torch.randn(B, S, H, D, generator=gen, device="cuda")
    delta = (dout * want).sum(-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, dout, want_lse, delta, True, D ** -0.5)
    atol, rtol = FLASH_BWD_TOL[torch.float32]
    got = dict(flash_bwd_dq=(TF.flash_bwd_dq(*args),),
               flash_bwd_dkv=TF.flash_bwd_dkv(*args))
    again = dict(flash_bwd_dq=(TF.flash_bwd_dq(*args),),
                 flash_bwd_dkv=TF.flash_bwd_dkv(*args))
    torch.cuda.synchronize()
    for kern, outs in got.items():
        if not all(map(torch.equal, outs, again[kern])):
            raise AssertionError(f"{kern} fp32 B=1: two calls differ")
    del again
    ref = dict(flash_bwd_dq=(TF.flash_bwd_dq_plain(*args),),
               flash_bwd_dkv=TF.flash_bwd_dkv_plain(*args))
    qt, kt, vt, gt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v, dout))
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        sdpa, (qt, kt, vt), gt, retain_graph=True), 10, flush)
    tensor, rowvec = B * S * H * D * 4, B * H * S * 4
    work = {"flash_bwd_dq": (3 * 2 * D * pairs, 5 * tensor + 2 * rowvec,
                             TF.flash_bwd_dq, TF.flash_bwd_dq_plain),
            "flash_bwd_dkv": (4 * 2 * D * pairs, 6 * tensor + 2 * rowvec,
                              TF.flash_bwd_dkv, TF.flash_bwd_dkv_plain)}
    fp32_bwd = {}
    for kern, (flops, nbytes, fn, plain_fn) in work.items():
        e = max((g - r).abs().max().item() for g, r in zip(got[kern],
                                                           ref[kern]))
        top = max(r.abs().max().item() for r in ref[kern])
        if not e <= atol + rtol * top:
            raise AssertionError(f"{kern} fp32 B=1: max_abs_err {e}")
        fp32_bwd[kern] = dict(
            shape=dict(B=B, S=S, H=H, D=D, causal=True, dtype="float32"),
            ms=time_ms(lambda: fn(*args), 10, flush),
            plain_ms=time_ms(lambda: plain_fn(*args), 2, flush),
            library_ms=lib_bwd, **split_tf32_bounds(nbytes, flops, 3),
            max_abs_err=e, repeats_bits=True)
        emit("kernels", kernel=kern, what="the fp32 kernel at B=1",
             library="scaled_dot_product_attention(is_causal=True) backward, "
             "fp32, dq+dk+dv in one call", flops=flops, bytes=nbytes,
             card=name, **fp32_bwd[kern])
    pair = time_ms(lambda: (TF.flash_bwd_dq(*args), TF.flash_bwd_dkv(*args)),
                   10, flush)
    emit("kernels", kernel="flash_bwd_dq+flash_bwd_dkv", what="the fp32 pair "
         "at B=1", ms=pair, library_ms=lib_bwd, ratio_to_library=pair / lib_bwd,
         library="scaled_dot_product_attention(is_causal=True) backward, "
         "fp32, dq+dk+dv in one call", card=name)
    del q, k, v, dout, qt, kt, vt, gt, sdpa, want, got, ref

    # GQA through the dispatcher (8 query heads over 2 kv heads, repeated
    # outside the kernel) against the plain mha path, fp32: 2e-4, the bound
    # of seed_tpu's own flash tests
    q = torch.randn(2, 512, 8, 128, generator=gen, device="cuda")
    k = torch.randn(2, 512, 2, 128, generator=gen, device="cuda")
    v = torch.randn(2, 512, 2, 128, generator=gen, device="cuda")
    got = TF.flash_attention(q, k, v, causal=True)
    want = mha(q, k, v, mask=sliced_causal_mask(512, 512, 0, "cuda"))
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not err <= 2e-4:
        raise AssertionError(f"flash_attention GQA: max_abs_err {err}")
    emit("kernels", kernel="flash_fwd", what="GQA 8/2 heads through "
         "flash_attention vs mha, fp32", max_abs_err=err, tol=2e-4, card=name)
    for kern in record:
        record[kern]["max_abs_err"] = worst[kern]
    record["flash_fwd"]["fp32"] = fp32
    for kern, timing in fp32_bwd.items():
        record[kern]["fp32"] = timing
    record["flash_fwd"]["fp32"]["autograd_step"] = flash_f32_step(name)
    record["flash_fwd"]["unet"] = unet
    return record


def _flash_unet_case(TF, mha, q, k, v, out, label, flush, name) -> dict:
    """The bf16 forward at one UNet self-attention shape, non-causal: whether
    ``unmasked_attention`` routes it to the kernel (and then its output is
    the kernel's, bit for bit), the kernel within FLASH_FWD_TOL of mha, and
    the kernel timed beside its bound (4·B·H·Sq·Sk·D operations at the bf16
    peak, or q, k, v, o and lse once at the memory rate), mha and the
    library's non-causal SDPA (never called by the port)."""
    import torch.nn.functional as F
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = D ** -0.5
    before = TF.flash_fwd.launches
    routed_out = TF.unmasked_attention(q, k, v)
    routed = TF.flash_fwd.launches == before + 1
    if routed != (Sq >= TF.MIN_FLASH_SEQ):
        raise AssertionError(f"unmasked_attention {label}: routed {routed}")
    if routed and not torch.equal(routed_out, out):
        raise AssertionError(f"unmasked_attention {label}: not the kernel's "
                             "output")
    ref = mha(q, k, v)
    torch.cuda.synchronize()
    mha_err = (out.float() - ref.float()).abs().max().item()
    if not mha_err <= FLASH_FWD_TOL[torch.bfloat16]:
        raise AssertionError(f"flash_fwd {label}: {mha_err} from mha")
    del routed_out, ref
    flops = 2 * 2 * D * B * H * Sq * Sk
    nbytes = (2 * B * Sq + 2 * B * Sk) * H * D * q.dtype.itemsize + B * H * Sq * 4
    bms, by = bound_ms(nbytes, flops, BF16_FLOPS)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ms = time_ms(lambda: TF.flash_fwd(q, k, v, False, scale), 10, flush)
    timing = dict(
        **label, routed=routed, max_abs_err_vs_mha=mha_err, ms=ms,
        tflop_per_s=flops / ms * 1e-9, bound_ms=bms, bound_by=by,
        roofline_share=bms / ms,
        plain_ms=time_ms(lambda: mha(q, k, v), 3, flush), plain="mha",
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                           10, flush),
        library="scaled_dot_product_attention, non-causal")
    emit("kernels", kernel="flash_fwd", what="the UNet's self-attention",
         card=name, **timing)
    return timing


# The fp32 kernels under autograd on a real step: SEED-LLaMA-8B's width (dim
# 4096, 32 heads of 128) cut to F32_STEP_LAYERS layers, an fp32 base and
# LoRA r=16, one micro-batch of 4 x 1024 tokens through train_llm.llm_loss
# with use_flash (the fp32 forward, dq and dk/dv kernels) and without (plain
# mha). The losses agree within 1e-4 relative and the adapters' gradients
# within 1e-3 of the largest (fp32 attention rounding through two layers'
# backward).
F32_STEP_LAYERS = 2


def flash_f32_step(name: str) -> dict:
    from seed_tpu_torch.models import llama as M
    from seed_tpu_torch.ops import flash_attention as TF
    from seed_tpu_torch.train import init_lora
    from seed_tpu_torch.train.train_llm import llm_loss
    from seed_tpu_torch.utils.tree import leaves, tree_map
    cfg = dataclasses.replace(M.SEED_LLAMA_8B, layers=F32_STEP_LAYERS)
    base = M.init_llama(torch.Generator(device="cuda").manual_seed(SEED + 13),
                        cfg, torch.float32)
    lora = init_lora(torch.Generator(device="cuda").manual_seed(SEED + 14),
                     base, r=16, alpha=32)
    batch = {k: torch.from_numpy(v[0]).cuda()
             for k, v in next(_train_batches(1, cfg.vocab_size, SEED + 15)).items()}
    kernels = (TF.flash_fwd, TF.flash_bwd_dq, TF.flash_bwd_dkv)
    out = {}
    for use_flash in (True, False):
        live = tree_map(lambda t: t.detach().clone().requires_grad_(), lora)
        trained = [t for t in leaves(live) if t.dim() >= 2]   # A and B
        before = [fn.launches_f32 for fn in kernels]
        loss = llm_loss(cfg, base, use_flash)({"lora": live}, batch, None)
        grads = torch.autograd.grad(loss, trained)
        out[use_flash] = dict(
            loss=loss.item(), grads=grads,
            launches={fn.__name__: fn.launches_f32 - b
                      for fn, b in zip(kernels, before)})
    flash, plain = out[True], out[False]
    rel = abs(flash["loss"] - plain["loss"]) / abs(plain["loss"])
    top = max(g.abs().max().item() for g in plain["grads"])
    grad_err = max((a - b).abs().max().item()
                   for a, b in zip(flash["grads"], plain["grads"]))
    record = dict(shape=dict(layers=cfg.layers, dim=cfg.dim, heads=cfg.heads,
                             B=TRAIN_MICRO, S=TRAIN_SEQ, dtype="float32"),
                  loss=flash["loss"], loss_plain=plain["loss"], loss_rel_err=rel,
                  grad_max_abs_err=grad_err, grad_max=top,
                  launches=flash["launches"])
    emit("kernels", kernel="tiled_flash", what="an fp32 autograd step, "
         "SEED-LLaMA-8B width cut to 2 layers + LoRA, train_llm.llm_loss, "
         "use_flash against plain mha", card=name, **record)
    if not all(flash["launches"].values()) or any(plain["launches"].values()):
        raise AssertionError(f"fp32 step launches: {flash['launches']}, "
                             f"plain {plain['launches']}")
    if not (rel <= 1e-4 and grad_err <= 1e-3 * top):
        raise AssertionError(f"fp32 step: loss rel err {rel}, gradient "
                             f"{grad_err} of {top}")
    return record


# -------------------------------------------------- phase 2, kernel row 6

# the four matmuls of a ViT block at B=8 (M = 8 x 257), 39 blocks per encode
W8A8_ENCODER = [(1408, 4224), (1408, 1408), (1408, 6144), (6144, 1408)]
W8A8_LLAMA = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 40320)]


def phase_w8a8_kernel(name: str, flush: torch.Tensor, usage: dict) -> dict:
    """Kernel row 6 against its plain version. The int32 sums are exact and
    the epilogue is two fp32 products in the plain version's order, so the
    kernel must equal the plain version bit for bit (the stated tolerance,
    one rounding of the output type, 2**-8 of max|y| in bf16 and 2**-23 in
    fp32, is checked too), and repeat its bits. The library yardstick is
    torch._int_mm plus the same epilogue (rows padded to 32 where M <= 16,
    which _int_mm refuses)."""
    import torch.nn.functional as F
    from seed_tpu_torch.ops import kernels
    from seed_tpu_torch.ops.int8_matmul import (_W8A8_SIGNATURES, w8a8_epilogue,
                                                w8a8_matmul, w8a8_matmul_plain)
    from seed_tpu_torch.ops.quantization import quantize_acts, quantize_weight

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    lib8 = kernels.load("w8a8_matmul", _W8A8_SIGNATURES)
    cases = [(2056, K, N, dt) for K, N in W8A8_ENCODER
             for dt in (torch.bfloat16, torch.float32)]
    cases += [(256, K, N, dt) for K, N in W8A8_LLAMA
              for dt in (torch.bfloat16, torch.float32)]
    cases += [(100, 1408, 4224, torch.bfloat16),    # ragged M below 128
              (16, 4096, 11008, torch.bfloat16)]    # decode rows (16 slots)
    worst = 0.0
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0)
    ops_total = bytes_total = 0.0
    for M, K, N, dtype in cases:
        qw = quantize_weight(torch.randn(K, N, generator=gen, device="cuda") * 0.02)
        xq, xs = quantize_acts(torch.randn(M, K, generator=gen, device="cuda") * 3)
        wq, ws = qw["kernel_q"], qw["scale"]
        got = w8a8_matmul(xq, xs, wq, ws, dtype)
        want = w8a8_matmul_plain(xq, xs, wq, ws, dtype)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        limit = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -23
        if not (rel <= limit and torch.equal(got, want)):
            raise AssertionError(f"w8a8_matmul M={M} K={K} N={N} {dtype}: "
                                 f"relative error {rel} (limit {limit}), "
                                 "not bit-equal to the plain version")
        _repeat_bits("w8a8_matmul", dict(M=M, K=K, N=N, out=str(dtype)),
                     lambda: w8a8_matmul(xq, xs, wq, ws, dtype), got)
        worst = max(worst, err)
        pad = (0, 0, 0, 32 - M) if M <= 16 else None

        def library():
            a = xq if pad is None else F.pad(xq, pad)
            return w8a8_epilogue(torch._int_mm(a, wq)[:M], xs, ws, dtype)

        if not torch.equal(library(), want):
            raise AssertionError(f"w8a8_matmul M={M} K={K} N={N}: the library "
                                 "yardstick computes another function")
        ms = time_ms(lambda: w8a8_matmul(xq, xs, wq, ws, dtype), flush=flush)
        plain = time_ms(lambda: w8a8_matmul_plain(xq, xs, wq, ws, dtype), 3,
                        flush)
        lib = time_ms(library, flush=flush)
        nbytes = M * K + K * N + 4 * M + 4 * N + M * N * dtype.itemsize
        ops = 2 * M * N * K
        bms, by = bound_ms(nbytes, ops, INT8_OPS)
        per_encode = 39 if (M == 2056 and dtype == torch.bfloat16) else 0
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib)):
            tot[key] += per_encode * val
        bytes_total += per_encode * nbytes
        ops_total += per_encode * ops
        tile = ("2/2/4/4" if M > 64 else "1/4/2/1") + (
            "/bf16" if dtype == torch.bfloat16 else "/f32")
        built = usage.get("w8a8_matmul", {}).get(tile, {})
        emit("kernels", kernel="w8a8_matmul", M=M, K=K, N=N,
             out=str(dtype).split(".")[-1], max_abs_err=err, rel_err=rel,
             tol_rel=limit, bit_equal=True, repeats_bits=True,
             instance=tile, registers=built.get("registers"),
             spill_bytes=spill_bytes(built), smem_bytes=lib8.seed_w8a8_smem_bytes(M),
             launches_per_encode=per_encode, card=name, ms=ms, plain_ms=plain,
             library_ms=lib, library="torch._int_mm + epilogue"
             + (", rows padded to 32" if pad else ""), bound_ms=bms,
             bound_by=by, tops=ops / ms / 1e9)
        del qw, xq, xs, wq, ws, got, want
    # the record is per launch, averaged over one encode's mix of shapes
    n = 39 * len(W8A8_ENCODER)
    bms, by = bound_ms(bytes_total / n, ops_total / n, INT8_OPS)
    record = dict(ms=tot["ms"] / n, plain_ms=tot["plain_ms"] / n,
                  library_ms=tot["library_ms"] / n, bound_ms=bms, bound_by=by,
                  max_abs_err=worst)
    emit("kernels", kernel="w8a8_matmul", summary="mean per launch over one "
         "W8A8 encode at B=8 (156 launches)", card=name, **record)
    return {"w8a8_matmul": record}


# ------------------------------------------ phase 2, the GroupNorm kernel

# (B, side, C): the UNet's largest GroupNorm input (CFG batch 2 at 96x96,
# the up path's 640 + 320 channels: the streaming design), the VAE's
# 768x768 x 256 (streaming) and the UNet's 24x24 x 1280, its commonest
# resident shape (11 of a pass's 61 norms)
GN_SHAPES = ((2, 96, 960), (1, 768, 256), (2, 24, 1280))
GN_GROUPS = 32


def phase_group_norm_kernel(name: str, flush: torch.Tensor) -> dict:
    """The GroupNorm kernel against the plain fp32 chain (fp32 input, scale
    and bias: its function unrounded), with and without SiLU: within one
    bf16 ulp of |y| plus 1e-5 of max |y| (the order of the fp32 sums), and
    bit for bit over two calls. Timed with SiLU (45 of a UNet pass's 61
    norms) beside the byte bound (x read once, y written once, bf16), the
    plain chain in bf16 with its SiLU pass (what the model ran before the
    kernel) and the library's F.group_norm on the NCHW view plus F.silu.
    The kernels line's row is the UNet's largest shape, the VAE's and the
    resident design's beside it."""
    import torch.nn.functional as F
    from seed_tpu_torch.ops import group_norm as GN

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    rows, worst = {}, 0.0
    for B, side, C in GN_SHAPES:
        m = 2 * torch.randn(C, generator=gen, device="cuda")
        sd = 0.5 + 1.5 * torch.rand(C, generator=gen, device="cuda")
        x = (torch.randn(B, side, side, C, generator=gen, device="cuda") * sd
             + m).to(torch.bfloat16)
        scale = torch.randn(C, generator=gen, device="cuda").to(torch.bfloat16)
        bias = torch.randn(C, generator=gen, device="cuda").to(torch.bfloat16)
        label = dict(B=B, H=side, W=side, C=C, groups=GN_GROUPS)
        for silu in (False, True):
            run = lambda: GN.group_norm_kernel(x, scale, bias, GN_GROUPS,
                                               1e-5, silu)
            got = run()
            want = GN.group_norm_plain(x.float(), scale.float(), bias.float(),
                                       GN_GROUPS, 1e-5, silu)
            err = (got.float() - want).abs()
            over = (err - 2.0 ** -7 * want.abs()
                    - 1e-5 * want.abs().max()).max().item()
            if not over <= 0:
                raise AssertionError(f"group_norm {label} silu={silu}: "
                                     f"{over} past one bf16 ulp")
            _repeat_bits("group_norm", dict(label, silu=silu), run, got)
            worst = max(worst, err.max().item())
            del got, want, err
        ms = time_ms(lambda: GN.group_norm_kernel(x, scale, bias, GN_GROUPS,
                                                  1e-5, True), flush=flush)
        ms_norm = time_ms(lambda: GN.group_norm_kernel(x, scale, bias,
                                                       GN_GROUPS), flush=flush)
        plain = time_ms(lambda: F.silu(GN.group_norm_plain(
            x, scale, bias, GN_GROUPS)), 3, flush)
        lib = time_ms(lambda: F.silu(F.group_norm(
            x.permute(0, 3, 1, 2), GN_GROUPS, scale, bias, 1e-5)), flush=flush)
        bms, by = bound_ms(2 * x.numel() * x.element_size(), 0, BF16_FLOPS)
        rows[(B, side, C)] = dict(
            shape=f"B={B} {side}x{side} C={C}, bf16, SiLU", ms=ms,
            ms_without_silu=ms_norm, plain_ms=plain, library_ms=lib,
            library="F.group_norm (NCHW view) + F.silu", bound_ms=bms,
            bound_by=by, bound_share=bms / ms,
            plan=list(GN.group_norm_plan(B, side * side, C, GN_GROUPS)))
        emit("kernels", kernel="group_norm", **label, max_abs_err=worst,
             card=name, **rows[(B, side, C)])
        del x
    record = dict(rows[GN_SHAPES[0]], max_abs_err=worst,
                  vae=rows[GN_SHAPES[1]], resident=rows[GN_SHAPES[2]])
    return {"group_norm": record}


# --------------------------------------------------------------- phase 3

def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def _flash_cfg(cfg, exact: bool):
    return dataclasses.replace(cfg, vit=dataclasses.replace(
        cfg.vit, use_flash=True, flash_exact=exact))


def phase_reference(name: str, params32, raw: torch.Tensor) -> None:
    """fp32, full width, 2 images: the encode through the short_mha kernel's
    exact epilogue against the same encode through the plain mha path. Only
    sum order differs, so pre-VQ features agree to 1e-3 of their scale."""
    from seed_tpu_torch.models import seed_tokenizer as ST
    from seed_tpu_torch.ops.preprocess import preprocess
    with torch.inference_mode():
        images = preprocess(raw[:2], 224, torch.float32)
        z_kernel = ST.encode_features(params32, images,
                                      _flash_cfg(ST.SEED_TOKENIZER, True))
        z_plain = ST.encode_features(params32, images, ST.SEED_TOKENIZER)
        cb = params32["vq"]["codebook"]
        from seed_tpu_torch.models.quantizer import nearest_codes
        same = (nearest_codes(cb, z_kernel) == nearest_codes(cb, z_plain))
    err = (z_kernel - z_plain).abs().max().item()
    scale = z_plain.abs().max().item()
    if not (math.isfinite(err) and err <= 1e-3 * scale):
        raise AssertionError(f"fp32 encode: kernel vs plain features differ by "
                             f"{err} (scale {scale})")
    emit("reference", what="fp32 encode, short_mha exact vs plain mha",
         images=2, max_abs_err=err, feature_scale=scale,
         id_agreement=same.float().mean().item(), card=name)


def phase_encode(name: str, params, raw: torch.Tensor) -> torch.Tensor:
    """Full SEED tokenizer in bf16: 8 uint8 256x256 images -> preprocess (the
    PIL-exact resize to 224) -> ids, exact and serving-fast configs."""
    from seed_tpu_torch.models import seed_tokenizer as ST
    from seed_tpu_torch.ops.flash_attention import short_mha
    from seed_tpu_torch.ops.preprocess import preprocess
    depth = ST.SEED_TOKENIZER.vit.depth
    ids = {}
    with torch.inference_mode():
        images = preprocess(raw, 224, torch.bfloat16)
        if images.shape != (8, 224, 224, 3) or not images.isfinite().all():
            raise AssertionError(f"preprocess: bad output {images.shape}")
        for label, cfg in (("default", ST.SEED_TOKENIZER),
                           ("exact", _flash_cfg(ST.SEED_TOKENIZER, True)),
                           ("fast", ST.serving_fast_config(ST.SEED_TOKENIZER))):
            before = short_mha.launches
            out = ST.encode(params, images, cfg)
            torch.cuda.synchronize()
            if short_mha.launches - before != depth:
                raise AssertionError(f"encode {label}: short_mha launched "
                                     f"{short_mha.launches - before} times, "
                                     f"not {depth}")
            if (out.shape != (8, 32) or out.dtype != torch.int32
                    or out.min() < 0 or out.max() >= 8192):
                raise AssertionError(f"encode {label}: bad ids {out.shape} "
                                     f"{out.dtype} [{out.min()}, {out.max()}]")
            reps = 3
            t0 = time.perf_counter()
            for _ in range(reps):
                again = ST.encode(params, images, cfg)
            torch.cuda.synchronize()
            seconds = (time.perf_counter() - t0) / reps
            if not torch.equal(again, out):
                raise AssertionError(f"encode {label}: ids differ between runs")
            ids[label] = out
            emit("encode", config=label, batch=8, img_per_s=8 / seconds,
                 ms_per_encode=seconds * 1e3,
                 short_mha_launches_per_encode=depth, card=name)
    # the default config and flash exact run the same mode-0 kernel on the
    # same inputs, so their ids are the same bits
    if not torch.equal(ids["default"], ids["exact"]):
        raise AssertionError("encode: the default config's ids differ from "
                             "flash exact's")
    agree = (ids["exact"] == ids["fast"]).float().mean().item()
    emit("encode", default_equals_exact=True,
         fast_vs_exact_id_agreement=agree, card=name)
    return ids["exact"]


# --------------------------------------------------------------- phase 4

def _plain(out):
    """Engine rows or interface segments as comparable Python values."""
    if out and hasattr(out[0], "kind"):
        return [(s.kind, s.text, None if s.image_codes is None
                 else s.image_codes.tolist()) for s in out]
    return out


def _check_segments(label: str, mode: str, segments) -> None:
    for s in segments:
        if s.kind == "text":
            if not isinstance(s.text, str):
                raise AssertionError(f"{label} {mode}: text segment without text")
        elif s.kind == "image":
            codes, emb = s.image_codes, s.image_embedding
            if codes.shape != (1, 32) or codes.min() < 0 or codes.max() >= 8192:
                raise AssertionError(f"{label} {mode}: bad image codes")
            if emb.shape != (1, 1024) or not (abs(emb) < float("inf")).all():
                raise AssertionError(f"{label} {mode}: bad image embedding")
        else:
            raise AssertionError(f"{label} {mode}: segment kind {s.kind}")


def init_llama_int8(name: str):
    """SEED-LLaMA-8B, seeded bf16 weights quantized to int8 layer by layer,
    built from configs/seed_llama_8b_8bit.json through the registry."""
    import seed_tpu_torch.registry_defs  # noqa: F401  (registers the names)
    from seed_tpu_torch.models import llama as M
    from seed_tpu_torch.utils.registry import instantiate, load_config
    path = Path(__file__).resolve().parent / "configs" / "seed_llama_8b_8bit.json"
    t0 = time.perf_counter()
    params, cfg = instantiate(load_config(str(path)), seed=SEED + 1)
    torch.cuda.synchronize()
    if cfg != M.SEED_LLAMA_8B or "kernel_q" not in params["layers"][0]["q_proj"]:
        raise AssertionError(f"{path.name} did not build the 8B int8 model")
    emit("serve", what="init SEED_LLAMA_8B, int8 layer by layer, through "
         "instantiate(load_config('configs/seed_llama_8b_8bit.json'))",
         seconds=time.perf_counter() - t0,
         gib_allocated=torch.cuda.memory_allocated() / 2 ** 30, card=name)
    return params


def phase_serve(name: str, params, tok_params, codes: torch.Tensor) -> None:
    """SEED-LLaMA-8B, int8 weights, served through LlamaEngine and
    SeedLlamaInterface."""
    from seed_tpu_torch.models import llama as M
    from seed_tpu_torch.models import seed_tokenizer as ST
    from seed_tpu_torch.ops.int8_matmul import can_use_kernel, int8_matmul
    from seed_tpu_torch.serving.engine import GenerationConfig, LlamaEngine
    from seed_tpu_torch.serving.multimodal import (ByteTextTokenizer,
                                                   SeedLlamaInterface)
    cfg = M.SEED_LLAMA_8B
    per_prefill = 7 * cfg.layers + 1     # q k v o gate up down, + lm_head
    engine = LlamaEngine(params, cfg, max_len=512)
    text = ByteTextTokenizer()
    iface = SeedLlamaInterface(engine, tok_params, ST.SEED_TOKENIZER, text)

    def expected(prompts) -> int:
        m = len(prompts) * engine._bucket(max(len(p) for p in prompts))
        return per_prefill if can_use_kernel(m, cfg.dim, cfg.dim) else 0

    def run(label, fn, prompts, gcfg):
        before = int8_matmul.launches
        t0 = time.perf_counter()
        out = fn(gcfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = int8_matmul.launches - before
        if launches != expected(prompts):
            raise AssertionError(f"{label}: int8_matmul launched {launches} "
                                 f"times, expected {expected(prompts)}")
        return out, seconds, launches

    greedy = GenerationConfig(max_new_tokens=24, do_sample=False)
    sampled = GenerationConfig(max_new_tokens=24, top_p=0.5)
    batch = [text.encode(f"Request {i}: describe a quiet harbour at dawn.",
                         add_bos=True) for i in range(4)]
    vqa = [codes[0].tolist(), "What is this?"]
    edit = [codes[1].tolist(), codes[2].tolist(),
            "Can you make the first picture look like the second one?"]
    requests = [
        ("batch", batch, lambda g: engine.generate(batch, g)),
        ("vqa", [iface.build_prompt(vqa)],
         lambda g: iface.generate(vqa, g)),
        ("force_image", [iface.build_prompt(edit)],
         lambda g: iface.generate(edit, g, force_image=True)),
    ]
    for label, prompts, fn in requests:
        outs = {}
        for mode, gcfg in (("greedy", greedy), ("greedy_again", greedy),
                           ("sampled", sampled)):
            out, seconds, launches = run(label, fn, prompts, gcfg)
            outs[mode] = out
            if label == "batch":
                tokens = [t for row in out for t in row]
                if any(not 0 <= t < cfg.vocab_size for t in tokens):
                    raise AssertionError(f"{label} {mode}: token outside the "
                                         "vocabulary")
                produced = dict(tokens=len(tokens))
            else:
                _check_segments(label, mode, out)
                produced = dict(segments=[s.kind for s in out])
            emit("serve", request=label, mode=mode, prompts=len(prompts),
                 prompt_tokens=[len(p) for p in prompts],
                 bucket=engine._bucket(max(len(p) for p in prompts)),
                 int8_matmul_launches=launches, seconds=seconds, card=name,
                 **produced)
        if _plain(outs["greedy"]) != _plain(outs["greedy_again"]):
            raise AssertionError(f"{label}: greedy output differs between runs")

    # prefill and decode timing at the batched request's shape (B=4, 64)
    ids = torch.tensor([[t for t in p] + [0] * (64 - len(p)) for p in batch],
                       device="cuda")
    with torch.inference_mode():
        cache = M.init_cache(cfg, 4, 512)
        before = int8_matmul.launches
        M.prefill(params, ids, cache, cfg)      # warm-up
        cache = M.init_cache(cfg, 4, 512)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = M.prefill(params, ids, cache, cfg)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        if int8_matmul.launches - before != 2 * per_prefill:
            raise AssertionError("prefill: int8_matmul launch count")
        if not logits[..., :cfg.vocab_size].isfinite().all():
            raise AssertionError("prefill: non-finite logits")
        tok = logits[:, -1].argmax(-1)
        steps = 16
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = M.decode_step(params, tok[:, None], cache, cfg)
            tok = logits[:, 0].argmax(-1)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    if int8_matmul.launches - before != 2 * per_prefill:
        raise AssertionError("decode: int8_matmul must not launch at M = 4")
    emit("serve", what="timing at B=4, bucket 64 (M=256)", prefill_ms=prefill_ms,
         decode_tok_per_s=4 * steps / decode_s,
         decode_ms_per_step=decode_s / steps * 1e3,
         int8_matmul_launches_per_prefill=per_prefill, card=name)


# --------------------------------------------------------------- phase 6

def phase_w8a8_encode(name: str, tok_params, raw: torch.Tensor):
    """The W8A8 encoder as bench.py composes it: quantize_for_serving +
    serving_fast_config, B=8. Returns the quantized params and config."""
    from seed_tpu_torch.models import seed_tokenizer as ST
    from seed_tpu_torch.ops.int8_matmul import w8a8_matmul
    from seed_tpu_torch.ops.preprocess import preprocess
    fast = ST.serving_fast_config(ST.SEED_TOKENIZER)
    qparams, qcfg = ST.quantize_for_serving(tok_params, ST.SEED_TOKENIZER)
    qcfg = ST.serving_fast_config(qcfg)
    per_encode = 4 * qcfg.vit.depth
    with torch.inference_mode():
        images = preprocess(raw, 224, torch.bfloat16)
        before = w8a8_matmul.launches
        z_q = ST.encode_features(qparams, images, qcfg)
        torch.cuda.synchronize()
        if w8a8_matmul.launches - before != per_encode:
            raise AssertionError(f"W8A8 encode: w8a8_matmul launched "
                                 f"{w8a8_matmul.launches - before} times, not "
                                 f"{per_encode}")
        z = ST.encode_features(tok_params, images, fast)
        cb = tok_params["vq"]["codebook"]
        from seed_tpu_torch.models.quantizer import nearest_codes
        ids_q, ids = nearest_codes(cb, z_q), nearest_codes(cb, z)
        rel = ((z_q.float() - z.float()).abs().max()
               / z.float().abs().max()).item()
        # two absmax int8 quantizations per matmul, 156 matmuls deep: the
        # features stay within a quarter of the bf16 encoder's scale
        if not (math.isfinite(rel) and rel <= 0.25):
            raise AssertionError(f"W8A8 encode: features differ from the bf16 "
                                 f"encoder's by {rel} of their scale")
        if ids_q.shape != (8, 32) or ids_q.min() < 0 or ids_q.max() >= 8192:
            raise AssertionError("W8A8 encode: bad ids")
        seconds = {}
        for label, p, c in (("w8a8", qparams, qcfg), ("bf16_fast", tok_params, fast),
                            ("w8a8", qparams, qcfg), ("bf16_fast", tok_params, fast)):
            for _ in range(3):
                t0 = time.perf_counter()
                out = ST.encode(p, images, c)
                torch.cuda.synchronize()
                seconds.setdefault(label, []).append(time.perf_counter() - t0)
            if label == "w8a8" and not torch.equal(out, ids_q):
                raise AssertionError("W8A8 encode: ids differ between runs")
    med = {k: statistics.median(v) for k, v in seconds.items()}
    emit("w8a8_encode", batch=8, w8a8_matmul_launches_per_encode=per_encode,
         img_per_s=8 / med["w8a8"], ms_per_encode=med["w8a8"] * 1e3,
         ms_runs=[t * 1e3 for t in seconds["w8a8"]],
         bf16_fast_img_per_s=8 / med["bf16_fast"],
         bf16_fast_ms_runs=[t * 1e3 for t in seconds["bf16_fast"]],
         feature_rel_err_vs_bf16=rel, feature_tol=0.25,
         id_agreement_vs_bf16=(ids_q == ids).float().mean().item(), card=name)
    return qparams, qcfg


class _Keep(dict):
    """The batcher's finished map, keeping every request that is popped so
    its t_submit / t_first / t_done can be read afterwards."""

    def __init__(self):
        super().__init__()
        self.popped = []

    def pop(self, key):
        req = super().pop(key)
        self.popped.append(req)
        return req


def _agreement(a, b) -> float:
    """Share of positions, over the shorter stream, with the same token."""
    n = min(len(a), len(b))
    return sum(x == y for x, y in zip(a, b)) / max(1, n)


SCHED_SLOTS, SCHED_MAX_LEN, SCHED_CHUNK, PREFIX_LEN = 16, 1024, 8, 256
# remainders after the 256-token prefix; the first is the prefix-hit check's
# prompt (456 tokens: 200 after the prefix, a 256-token chunk, M >= 256)
HIT_REMAINDERS = [200, 20, 40, 64, 100, 130, 300, 444, 30, 50, 90, 150]
# prompts without the prefix; 600 and 700 exceed the largest bucket (512) and
# take two prefill chunks
MISS_LENGTHS = [300, 20, 45, 64, 100, 128, 200, 256, 500, 600, 700, 33]


def phase_scheduler(name: str, params):
    """ScheduledEngine: 16 fp8 slots, max_len 1024, decode_chunk 8, one
    registered 256-token prefix, 24 requests from 4 threads. Returns the
    engine (still open) for the HTTP phase."""
    from seed_tpu_torch import BOI_TOKEN_ID
    from seed_tpu_torch.models import llama as M
    from seed_tpu_torch.ops.int8_matmul import int8_matmul
    from seed_tpu_torch.serving.engine import GenerationConfig
    from seed_tpu_torch.serving.scheduler import ScheduledEngine
    cfg = M.SEED_LLAMA_8B
    rs = np.random.RandomState(SEED + 7)
    words = lambda n: rs.randint(3, 32000, n).tolist()
    prefix = [1] + words(PREFIX_LEN - 1)
    hits = [prefix + words(n) for n in HIT_REMAINDERS]
    misses = [[1] + words(n - 1) for n in MISS_LENGTHS]

    def engine(dtype, with_prefix=True):
        se = ScheduledEngine(params, cfg, slots=SCHED_SLOTS,
                             max_len=SCHED_MAX_LEN, cache_dtype=dtype,
                             decode_chunk=SCHED_CHUNK)
        if with_prefix:
            se.register_prefix(prefix)
        return se

    greedy = GenerationConfig(max_new_tokens=24, do_sample=False)
    sampled = [GenerationConfig(max_new_tokens=32, temperature=t, top_p=p)
               for t, p in ((0.7, 0.5), (1.0, 0.9), (1.3, 0.7))]
    forced = GenerationConfig(max_new_tokens=32, temperature=0.7, top_p=0.5,
                              forced_first_token=BOI_TOKEN_ID)
    # a quarter greedy; three sampled groups with their own temperature and
    # top_p and their own seed; two force_boi. Half of all start with the
    # prefix.
    calls = [
        [(hits[0:3] + misses[0:3], greedy, None)],
        [(hits[3:6] + misses[3:6], sampled[0], 11)],
        [(hits[6:9] + misses[6:9], sampled[1], 12)],
        [(hits[9:11] + misses[9:11], sampled[2], 13),
         ([hits[11], misses[11]], forced, 14)],
    ]
    torch.cuda.reset_peak_memory_stats()
    se = engine(torch.float8_e4m3fn)
    keep = se.batcher.finished = _Keep()
    results, errors = {}, []

    def client(i):
        try:
            for j, (prompts, gen, seed) in enumerate(calls[i]):
                results[i, j] = se.generate(prompts, gen, seed=seed)
        except BaseException as e:      # re-raised on the main thread
            errors.append(e)

    before = int8_matmul.launches
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    if errors:
        raise errors[0]
    kernel2 = int8_matmul.launches - before
    n_req = n_tok = 0
    for (i, j), outs in results.items():
        prompts, gen, _ = calls[i][j]
        for toks in outs:
            n_req += 1
            n_tok += len(toks)
            if not 0 < len(toks) <= gen.max_new_tokens:
                raise AssertionError(f"scheduler: a request of call {i},{j} "
                                     f"returned {len(toks)} tokens, budget "
                                     f"{gen.max_new_tokens}")
            if any(not 0 <= t < cfg.vocab_size for t in toks):
                raise AssertionError("scheduler: token outside the vocabulary")
        if gen.forced_first_token is not None and any(
                toks[0] != BOI_TOKEN_ID for toks in outs):
            raise AssertionError("scheduler: force_boi did not force BOI")
    if n_req != 24 or len(keep.popped) != 24:
        raise AssertionError(f"scheduler: {n_req} of 24 requests finished")
    # every chunk in the 256 or 512 bucket launches kernel 2 on the seven
    # projections of each layer
    if kernel2 <= 0 or kernel2 % (7 * cfg.layers):
        raise AssertionError(f"scheduler: int8_matmul launched {kernel2} times")
    ttft = [r.t_first - r.t_submit for r in keep.popped]
    latency = [r.t_done - r.t_submit for r in keep.popped]
    emit("scheduler", what="24 requests from 4 threads, 16 fp8 slots, max_len "
         "1024, decode_chunk 8, one 256-token prefix", requests=n_req,
         new_tokens=n_tok, drain_seconds=drain_s, tokens_per_s=n_tok / drain_s,
         ttft_s_median=statistics.median(ttft), ttft_s_max=max(ttft),
         latency_s_median=statistics.median(latency), latency_s_max=max(latency),
         int8_matmul_launches=kernel2,
         prefill_chunks_at_m_256_or_more=kernel2 // (7 * cfg.layers),
         max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         card=name)

    # the same requests served alone
    hit, miss = hits[0], misses[0]
    mix_hit, mix_miss = results[0, 0][0], results[0, 0][3]
    alone = se.generate([hit], greedy)[0], se.generate([miss], greedy)[0]
    if alone != (mix_hit, mix_miss):
        raise AssertionError("scheduler: a greedy request gave other tokens "
                             "alone than in the mix")
    seeded_mix = results[1, 0][0]
    seeded_alone = se.generate([calls[1][0][0][0]], sampled[0], seed=11)[0]
    if seeded_alone != seeded_mix:
        raise AssertionError("scheduler: a seeded sampled request did not "
                             "reproduce under the mix")
    other_seed = se.generate([calls[1][0][0][0]], sampled[0], seed=12)[0]
    emit("scheduler", greedy_alone_equals_mix=True, seeded_alone_equals_mix=True,
         other_seed_differs=other_seed != seeded_alone, card=name)

    # bf16 slots: a prefix hit against the same prompt with no prefix
    # registered; and the fp8 slots' agreement with bf16 (informational)
    bf = engine(torch.bfloat16)
    bf_hit, bf_miss = bf.generate([hit], greedy)[0], bf.generate([miss], greedy)[0]
    bf.close()
    del bf
    plain = engine(torch.bfloat16, with_prefix=False)
    no_prefix = plain.generate([hit], greedy)[0]
    plain.close()
    del plain
    torch.cuda.empty_cache()
    if bf_hit != no_prefix:
        raise AssertionError(f"scheduler: under bf16 slots a prefix hit gave "
                             f"{bf_hit}, the run without the prefix {no_prefix}")
    emit("scheduler", prefix_hit_equals_no_prefix_bf16=True,
         prompt_tokens=len(hit), new_tokens=len(bf_hit),
         fp8_vs_bf16_greedy_agreement=[_agreement(mix_hit, bf_hit),
                                       _agreement(mix_miss, bf_miss)],
         card=name)
    return se


def phase_http(name: str, se, qparams, qcfg, decoder) -> None:
    """The /generate service in-process on an ephemeral port: the scheduled
    engine behind SeedLlamaInterface with the W8A8 tokenizer and the unCLIP
    de-tokenizer attached (``decoder``), as ``--diffusion-ckpt`` builds it."""
    from PIL import Image
    from seed_tpu_torch import IMG_FLAG
    from seed_tpu_torch.ops.int8_matmul import w8a8_matmul
    from seed_tpu_torch.serving.multimodal import SeedLlamaInterface
    from seed_tpu_torch.serving.server import GenerateService, make_server
    service = GenerateService(SeedLlamaInterface(se, qparams, qcfg,
                                                 diffusion=decoder))
    server = make_server(service, host="127.0.0.1", port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def post(payload):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read()), time.perf_counter() - t0

    try:
        pixels = np.random.RandomState(SEED + 8).randint(
            0, 256, (300, 400, 3), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(pixels).save(buf, format="PNG")
        before = w8a8_matmul.launches
        answers = [
            post({"text": f"USER: {IMG_FLAG} What is in the picture?\nASSISTANT:",
                  "images": [base64.b64encode(buf.getvalue()).decode("ascii")],
                  "max_new_tokens": 24}),
            post({"text": f"USER: {IMG_FLAG} Draw it at night.\nASSISTANT:",
                  "images": [list(range(100, 132))], "force_boi": True,
                  "max_new_tokens": 40, "temperature": 0.7, "top_p": 0.5}),
            post({"text": f"one {IMG_FLAG} and {IMG_FLAG}", "images": [[1] * 32]}),
        ]
        encoded = w8a8_matmul.launches - before
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    for status, body, _ in answers:
        if status != 200 or set(body) != {"text", "images", "images_ids",
                                          "error_msg"}:
            raise AssertionError(f"http: status {status}, keys {sorted(body)}")
        if (not isinstance(body["text"], str)
                or len(body["images"]) != body["text"].count(IMG_FLAG)
                or any(len(ids) != 32 for ids in body["images_ids"])):
            raise AssertionError(f"http: malformed response {body}")
    (_, png, s0), (_, boi, s1), (_, bad, _) = answers
    if len(png["images_ids"]) < 1 or png["images_ids"][0] == boi["images_ids"][0]:
        raise AssertionError("http: the uploaded image was not encoded")
    if boi["images_ids"][0] != list(range(100, 132)):
        raise AssertionError("http: cached ids were not passed through")
    if not bad["error_msg"] or bad["text"] or "placeholders" not in bad["error_msg"][0]:
        raise AssertionError(f"http: a mismatched {IMG_FLAG} count answered {bad}")
    if encoded != 4 * qcfg.vit.depth:       # one pixel image, one encode
        raise AssertionError(f"http: w8a8_matmul launched {encoded} times")
    # a generated block that closed validly comes back as a 768 x 768 PNG
    pngs = [b64 for body in (png, boi) for b64 in body["images"] if b64]
    for b64 in pngs:
        img = Image.open(io.BytesIO(base64.b64decode(b64)))
        if img.format != "PNG" or img.size != (768, 768) or img.mode != "RGB":
            raise AssertionError(f"http: an image came back as {img.format} "
                                 f"{img.size} {img.mode}")
    emit("http", what="POST /generate with the unCLIP de-tokenizer attached: "
         "a base64 PNG; cached ids + force_boi; a mismatched <image> count",
         seconds=[s0, s1],
         text_chars=[len(png["text"]), len(boi["text"])],
         images=[len(png["images"]), len(boi["images"])],
         pngs_returned=len(pngs),
         error_msg=[png["error_msg"], boi["error_msg"], bad["error_msg"]],
         w8a8_matmul_launches=encoded, card=name)


def phase_caches_and_beam(name: str, params, tok_params, codes) -> None:
    """LlamaEngine with fp8 and int8 ring caches against bf16, and one
    num_beams=5 caption-style request."""
    from seed_tpu_torch.models import llama as M
    from seed_tpu_torch.models import seed_tokenizer as ST
    from seed_tpu_torch.serving.engine import GenerationConfig, LlamaEngine
    from seed_tpu_torch.serving.multimodal import (ByteTextTokenizer,
                                                   SeedLlamaInterface)
    cfg = M.SEED_LLAMA_8B
    text = ByteTextTokenizer()
    batch = [text.encode(f"Request {i}: describe a quiet harbour at dawn.",
                         add_bos=True) for i in range(4)]
    greedy = GenerationConfig(max_new_tokens=24, do_sample=False)
    dtypes = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn,
              "int8": torch.int8}
    out, state = {}, {}
    ids = torch.tensor([p + [0] * (64 - len(p)) for p in batch], device="cuda")
    for label, dtype in dtypes.items():
        engine = LlamaEngine(params, cfg, max_len=512, cache_dtype=dtype)
        out[label] = engine.generate(batch, greedy)
        if out[label] != engine.generate(batch, greedy):
            raise AssertionError(f"ring cache {label}: greedy output differs "
                                 "between runs")
        tokens = [t for row in out[label] for t in row]
        if not tokens or any(not 0 <= t < cfg.vocab_size for t in tokens):
            raise AssertionError(f"ring cache {label}: bad tokens")
        with torch.inference_mode():
            cache = M.init_cache(cfg, 4, 512, dtype)
            logits, cache = M.prefill(params, ids, cache, cfg)
        state[label] = (logits[:, -1].argmax(-1), cache)
    # decode is bound by the host's launches and its time swings between
    # calls: the three caches take turns, 5 rounds of 8 steps each (after a
    # warm-up round), and each reports its median round
    rounds = {label: [] for label in dtypes}
    with torch.inference_mode():
        for r in range(6):
            for label in dtypes:
                tok, cache = state[label]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(8):
                    logits, cache = M.decode_step(params, tok[:, None], cache, cfg)
                    tok = logits[:, 0].argmax(-1)
                torch.cuda.synchronize()
                if r:
                    rounds[label].append((time.perf_counter() - t0) / 8 * 1e3)
                state[label] = (tok, cache)
                if not logits[..., :cfg.vocab_size].isfinite().all():
                    raise AssertionError(f"ring cache {label}: non-finite logits")
    step_ms = {label: statistics.median(v) for label, v in rounds.items()}
    del state, cache, logits
    agree = {label: statistics.mean(_agreement(a, b) for a, b in
                                    zip(out[label], out["bf16"]))
             for label in ("fp8", "int8")}
    emit("ring_cache", what="LlamaEngine.generate, B=4, bucket 64, max_len 512, "
         "24 greedy tokens", decode_ms_per_step_median=step_ms,
         decode_ms_per_step_rounds=rounds,
         greedy_agreement_with_bf16=agree, card=name)

    iface = SeedLlamaInterface(LlamaEngine(params, cfg, max_len=512), tok_params,
                               ST.SEED_TOKENIZER, text)
    prompt = iface.build_prompt([codes[0].tolist(), "Describe the image."])
    beam = GenerationConfig(max_new_tokens=16, num_beams=5, length_penalty=1.0)
    t0 = time.perf_counter()
    best = iface.engine.generate([prompt], beam)[0]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not 0 < len(best) <= 16 or any(not 0 <= t < cfg.vocab_size for t in best):
        raise AssertionError(f"beam: bad output {best}")
    if best != iface.engine.generate([prompt], beam)[0]:
        raise AssertionError("beam: output differs between runs")
    emit("beam", what="num_beams=5 caption-style request, bf16 ring cache",
         prompt_tokens=len(prompt), new_tokens=len(best), seconds=seconds,
         ms_per_step=seconds / 16 * 1e3, card=name)


# --------------------------------------------------------------- phase 8

# One full-width UNet pass in bf16 (weights and activations) against the
# same pass in fp32 with TF32 off: the largest difference within 5e-2 of the
# fp32 output's largest magnitude. The CPU tests' SD-like UNet (3 levels,
# head dim 64, 32 groups) gives 1.2e-2; SD2.1 is one level and 640 channels
# deeper.
UNET_BF16_TOL = 5e-2
# The 20-step decode in bf16 against fp32 on the same embedding and
# latents, pixels in [0, 1]: the mean absolute difference within 0.1. The
# two precisions compute one function; 20 guided steps (guidance 10 scales
# the difference of the two CFG halves tenfold) carry the UNet's bf16 error
# into the latents, so the pixels differ in place, not on average.
PIXEL_MEAN_TOL = 0.1
# flash forward launches of one bf16 UNet pass at 96x96 latents: the
# self-attention of levels 0-2 (9,216, 2,304 and 576 tokens, five calls
# each) through flash_attention.unmasked_attention; the mid block's 144
# tokens and every cross-attention (77 keys) stay on mha
UNET_FLASH_CALLS = 15
DDIM_STEPS = 20


def unet_gn_calls(u) -> int:
    """GroupNorm kernel launches of one bf16 UNet pass: two a resnet, one a
    spatial transformer, the output's (61 at SD2.1's UNet)."""
    resnets = len(u.block_channels) * (2 * u.layers_per_block + 1) + 2
    blocks = sum(u.attn_levels) * (2 * u.layers_per_block + 1) + 1
    return 2 * resnets + 1 + blocks


def vae_gn_calls(v) -> int:
    """GroupNorm kernel launches of one bf16 VAE decode: two a resnet, the
    mid attention's, the output's (30 at SD2.1's VAE)."""
    return 2 * (2 + len(v.channel_mults) * (v.layers_per_block + 1)) + 2


def _launch_counts() -> dict:
    """The launch counters of the six kernel rows and the GroupNorm
    kernel."""
    from seed_tpu_torch.ops import flash_attention as TF
    from seed_tpu_torch.ops.group_norm import group_norm_kernel
    from seed_tpu_torch.ops.int8_matmul import int8_matmul, w8a8_matmul
    return {fn.__name__: fn.launches for fn in (
        TF.short_mha, int8_matmul, TF.flash_fwd, TF.flash_bwd_dq,
        TF.flash_bwd_dkv, w8a8_matmul, group_norm_kernel)}


def _launched_since(before: dict) -> dict:
    return {k: n - before[k] for k, n in _launch_counts().items()}


def init_unclip_full(name: str):
    """The SD2.1 unCLIP de-tokenizer (UNet + VAE decoder) with seeded random
    weights on the card: fp32, and its bf16 copy that serving decodes with."""
    from seed_tpu_torch.models.unclip import SD21_UNCLIP, init_unclip
    from seed_tpu_torch.utils.tree import leaves
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    t0 = time.perf_counter()
    p32 = init_unclip(gen, SD21_UNCLIP, torch.float32)
    p16 = _cast(p32, torch.bfloat16)
    torch.cuda.synchronize()
    count = lambda tree: sum(t.numel() for t in leaves(tree))
    emit("detokenize", what="init SD21_UNCLIP fp32 and its bf16 copy",
         seconds=time.perf_counter() - t0, unet_params=count(p32["unet"]),
         vae_params=count(p32["vae"]),
         bf16_gib=sum(t.numel() * 2 for t in leaves(p16)) / 2 ** 30,
         gib_allocated=torch.cuda.memory_allocated() / 2 ** 30, card=name)
    return p32, p16


def phase_unet_pass(name: str, p32, p16) -> None:
    """One SD2.1 UNet pass at the decode's shape (CFG batch 2 at 96x96x4, a
    [2, 77, 1024] context, the first DDIM timestep) in bf16 and in fp32."""
    from torch.utils.flop_counter import FlopCounterMode
    from seed_tpu_torch.models.unclip import (SD21_UNCLIP,
                                              noise_image_embeddings,
                                              unet_apply)
    cfg = SD21_UNCLIP
    n = cfg.latent_size
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    lat = torch.randn((2, n, n, 4), generator=gen, device="cuda")
    ctx = torch.randn((2, cfg.text_ctx_len, cfg.text_ctx_dim), generator=gen,
                      device="cuda")
    emb = torch.randn((1, cfg.image_embed_dim), generator=gen, device="cuda")
    out, ms, transient, launched = {}, {}, {}, {}
    with torch.inference_mode():
        cond = noise_image_embeddings(p32, emb, 0, None, cfg)
        labels = torch.cat([torch.zeros_like(cond), cond])
        t = torch.full((2,), 951, dtype=torch.int32, device="cuda")
        for label, p, dtype in (("fp32", p32, torch.float32),
                                ("bf16", p16, torch.bfloat16)):
            args = (p["unet"], lat.to(dtype), t, ctx.to(dtype),
                    labels.to(dtype), cfg.unet)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            before = _launch_counts()
            out[label] = unet_apply(*args).float()
            launched[label] = _launched_since(before)
            torch.cuda.synchronize()
            transient[label] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            ms[label] = time_ms(lambda: unet_apply(*args), iters=3)
            if label == "fp32":
                # mha's einsums carry the attention's work into the count;
                # the flash kernel, a ctypes call, is not seen by it
                with FlopCounterMode(display=False) as counter:
                    unet_apply(*args)
    flops = counter.get_total_flops()
    ref = out["fp32"]
    if out["bf16"].shape != (2, n, n, 4) or not out["bf16"].isfinite().all():
        raise AssertionError("UNet pass: bad bf16 output")
    rel = ((out["bf16"] - ref).abs().max() / ref.abs().max()).item()
    if not (math.isfinite(rel) and rel <= UNET_BF16_TOL):
        raise AssertionError(f"UNet pass: bf16 differs from fp32 by {rel} of "
                             f"the output's scale (bound {UNET_BF16_TOL})")
    want = {"fp32": dict.fromkeys(launched["fp32"], 0)}
    want["bf16"] = dict(want["fp32"], flash_fwd=UNET_FLASH_CALLS,
                        group_norm_kernel=unet_gn_calls(cfg.unet))
    if launched != want:
        raise AssertionError(f"UNet pass launched {launched}, not {want}")
    emit("detokenize", what="one SD21 UNet pass, CFG batch 2 at 96x96x4, "
         "context [2, 77, 1024], t=951; fp32 with TF32 off", ms_bf16=ms["bf16"],
         ms_fp32=ms["fp32"], gflop=flops / 1e9,
         tflop_per_s_bf16=flops / ms["bf16"] / 1e9,
         bound_ms_bf16=flops / BF16_FLOPS * 1e3,
         rel_err_bf16_vs_fp32=rel, tol=UNET_BF16_TOL,
         transient_gib=transient,
         level0_mha_scores_gib=2 * 5 * (n * n) ** 2 * 4 / 2 ** 30,
         kernel_launches=launched, card=name)


class _Recorder:
    """An engine that keeps the ids of its last generation."""

    def __init__(self, engine):
        self.engine, self.last = engine, None

    def generate(self, prompts, gen, seed: int = 0):
        out = self.engine.generate(prompts, gen, seed=seed)
        self.last = out[0]
        return out


def phase_detokenize(name: str, params, tok_params, codes: torch.Tensor,
                     p32, decoder) -> None:
    """encode -> generate -> pixels through SeedLlamaInterface with the
    unCLIP decoder attached (bf16, offloaded, 20 steps, guidance 10), and the
    same 20-step decode in fp32."""
    from PIL import Image
    from seed_tpu_torch import BOI_TOKEN_ID
    from seed_tpu_torch.models import llama as M
    from seed_tpu_torch.models import seed_tokenizer as ST
    from seed_tpu_torch.models.unclip import (SD21_UNCLIP, decode_to_images,
                                              generate_latents)
    from seed_tpu_torch.serving.engine import GenerationConfig, LlamaEngine
    from seed_tpu_torch.serving.multimodal import (ByteTextTokenizer,
                                                   SeedLlamaInterface,
                                                   image_ids_to_tokens)
    from seed_tpu_torch.serving.server import encode_image_b64
    cfg = SD21_UNCLIP
    side = cfg.latent_size * cfg.vae.upscale
    engine = _Recorder(LlamaEngine(params, M.SEED_LLAMA_8B, max_len=512))
    iface = SeedLlamaInterface(engine, tok_params, ST.SEED_TOKENIZER,
                               ByteTextTokenizer(), diffusion=decoder)
    edit = [codes[1].tolist(), codes[2].tolist(),
            "Can you make the first picture look like the second one?"]
    t0 = time.perf_counter()
    iface.generate(edit, GenerationConfig(max_new_tokens=24, do_sample=False),
                   force_image=True)
    generate_s = time.perf_counter() - t0
    if engine.last[0] != BOI_TOKEN_ID:
        raise AssertionError("detokenize: force_image did not force BOI")

    # the generated stream with a valid block appended: the 32 ids that
    # phase 4's encode gave its first image
    block = codes[0].tolist()
    stream = list(engine.last) + image_ids_to_tokens(block)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = _launch_counts()
    t0 = time.perf_counter()
    segments = iface.split_output(stream)
    split_s = time.perf_counter() - t0
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    launched = _launched_since(before)
    images = [s for s in segments if s.kind == "image"]
    if not images or images[-1].image_codes.tolist() != [block]:
        raise AssertionError("detokenize: the appended block did not come "
                             f"back as an image: {[s.kind for s in segments]}")
    seg = images[-1]
    img = seg.image
    if (seg.image_embedding is not None or img is None
            or img.shape != (1, side, side, 3) or img.dtype != np.float32
            or not np.isfinite(img).all() or img.min() < 0 or img.max() > 1):
        raise AssertionError(f"detokenize: bad image segment "
                             f"{getattr(img, 'shape', None)}")
    png = Image.open(io.BytesIO(base64.b64decode(encode_image_b64(img[0]))))
    if png.format != "PNG" or png.size != (side, side) or png.mode != "RGB":
        raise AssertionError(f"detokenize: PNG {png.format} {png.size} {png.mode}")
    want = dict.fromkeys(launched, 0)
    want["flash_fwd"] = DDIM_STEPS * UNET_FLASH_CALLS
    want["group_norm_kernel"] = (DDIM_STEPS * unet_gn_calls(cfg.unet)
                                 + vae_gn_calls(cfg.vae))
    if launched != want:
        raise AssertionError(f"detokenize launched {launched}, not {want}")

    # the same decode, part by part, then in fp32 on the same embedding and
    # latents
    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with torch.inference_mode():
        emb, embed_s = timed(lambda: ST.decode_embedding(
            tok_params, codes[:1], ST.SEED_TOKENIZER).float())
        p, swap_s = timed(decoder._params.acquire)
        try:
            lat, unet_s = timed(lambda: generate_latents(
                p, emb, decoder.latents, cfg, 20, 10.0))
            img16, vae_s = timed(lambda: decode_to_images(p, lat, cfg).float())
        finally:
            decoder._params.release()
        del p, lat
        img32, fp32_s = timed(lambda: decode_to_images(p32, generate_latents(
            p32, emb, decoder.latents.float(), cfg, 20, 10.0), cfg))
    got = torch.from_numpy(img).cuda()
    repeat = (img16 - got).abs().max().item()
    diff = (img32 - got).abs()
    max_d, mean_d = diff.max().item(), diff.mean().item()
    if not (math.isfinite(mean_d) and mean_d <= PIXEL_MEAN_TOL):
        raise AssertionError(f"detokenize: fp32 and bf16 pixels differ by "
                             f"{mean_d} on average (bound {PIXEL_MEAN_TOL})")
    emit("detokenize", what="encode -> 8B int8 generate (force_image) -> a "
         "valid block appended -> split_output -> pixels (bf16 decoder, "
         "offload, 20 DDIM steps, guidance 10)", generate_seconds=generate_s,
         generated_tokens=len(engine.last), decode_seconds=split_s,
         decode_split_seconds={"decode_embedding": embed_s, "swap_in": swap_s,
                               "unet_20_steps": unet_s, "vae": vae_s},
         decode_peak_gib_over_resident=peak_gib, image=list(img.shape),
         png=list(png.size), repeat_max_abs_diff=repeat,
         kernel_launches=launched, card=name)
    emit("detokenize", what="the 20-step decode in fp32 (TF32 off) against "
         "bf16, same embedding and latents", fp32_seconds=fp32_s,
         max_abs_pixel_diff=max_d, mean_abs_pixel_diff=mean_d,
         mean_tol=PIXEL_MEAN_TOL, card=name)


# --------------------------------------------------------------- phase 7

TRAIN_MICRO, TRAIN_SEQ, TRAIN_ACCUM = 4, 1024, 2
# bf16 activations through 32 layers, attention probabilities rounded at
# other points (tiled online softmax against one whole-row softmax): the two
# losses (about ln 40194 = 10.6 at random init) agree to 0.02
TRAIN_LOSS_TOL = 0.02


def _train_batches(n: int, vocab: int, seed: int):
    """Seeded batches in the data collate's layout, [grad_accum, micro, S]:
    right-padded, attention_mask 1 on real tokens, labels -100 on padding."""
    rs = np.random.RandomState(seed)
    shape = (TRAIN_ACCUM, TRAIN_MICRO, TRAIN_SEQ)
    for _ in range(n):
        ids = rs.randint(3, vocab, shape).astype(np.int32)
        lengths = rs.randint(TRAIN_SEQ // 2, TRAIN_SEQ + 1, shape[:2])
        mask = (np.arange(TRAIN_SEQ) < lengths[..., None]).astype(np.int32)
        yield {"input_ids": ids * mask, "attention_mask": mask,
               "labels": np.where(mask == 1, ids, -100).astype(np.int32)}


def _fingerprint(tree) -> list:
    """Exact integer checksum of every leaf's bits."""
    from seed_tpu_torch.utils.tree import leaves
    return [int(t.view(torch.int16).to(torch.int64).sum()) for t in leaves(tree)]


def llm_loss(base, cfg, use_flash: bool):
    """The LoRA training loss: adapters merged into the frozen ``base``,
    forward with per-layer recompute, next-token cross entropy."""
    from seed_tpu_torch.models import llama as M
    from seed_tpu_torch.train import apply_lora, cross_entropy

    def loss_fn(lora, batch, rng):
        logits = M.forward(apply_lora(base, lora), batch["input_ids"], cfg,
                           attn_mask=batch["attention_mask"], remat=True,
                           use_flash=use_flash)
        return cross_entropy(logits[:, :-1], batch["labels"][:, 1:])
    return loss_fn


def llm_trainer(base, cfg, lora):
    """Trainer over the adapter tree; the loss closes over the frozen base.
    AdamW of the LLM recipe, cosine schedule with one warm-up step."""
    from seed_tpu_torch.train import (Trainer, TrainerConfig, adamw,
                                      cosine_with_floor)
    opt = adamw(cosine_with_floor(1.5e-4, 1, 8, 0.05), b1=0.9, b2=0.95,
                eps=1e-5, weight_decay=0.05, clip_norm=1.0, params=lora)
    return Trainer(llm_loss(base, cfg, True), lora, opt,
                   TrainerConfig(grad_accum=TRAIN_ACCUM))


def phase_train(name: str):
    """LoRA fine-tuning of SEED-LLaMA-8B through Trainer; returns the flash
    kernels' launch counts over the counted steps and the median step ms."""
    from seed_tpu_torch.models import llama as M
    from seed_tpu_torch.ops import flash_attention as TF
    from seed_tpu_torch.train import init_lora
    from seed_tpu_torch.utils import CheckpointManager
    from seed_tpu_torch.utils.tree import leaves_with_path
    cfg = M.SEED_LLAMA_8B
    t0 = time.perf_counter()
    base = M.init_llama(torch.Generator(device="cuda").manual_seed(SEED + 3),
                        cfg, torch.bfloat16)
    make_lora = lambda: init_lora(
        torch.Generator(device="cuda").manual_seed(SEED + 4), base, r=16, alpha=32)
    lora0 = make_lora()
    torch.cuda.synchronize()
    n_adapter = sum(t.numel() for _, t in leaves_with_path(lora0))
    emit("train", what="init SEED_LLAMA_8B bf16 + LoRA r=16 alpha=32",
         seconds=time.perf_counter() - t0, layers=cfg.layers,
         adapter_params=n_adapter,
         gib_allocated=torch.cuda.memory_allocated() / 2 ** 30, card=name)
    before = _fingerprint(base)
    loss_with = lambda use_flash: llm_loss(base, cfg, use_flash)
    trainer = lambda: llm_trainer(base, cfg, make_lora())

    data = list(_train_batches(3, cfg.vocab_size, SEED + 5))

    # the first micro-batch's loss through the kernels against the same loss
    # through the plain mha path (not counted as the main path)
    micro = {k: torch.as_tensor(v[0]).cuda() for k, v in data[0].items()}
    with torch.no_grad():
        loss_kernel = loss_with(True)(lora0, micro, None).item()
        loss_plain = loss_with(False)(lora0, micro, None).item()
    if not (math.isfinite(loss_kernel)
            and abs(loss_kernel - loss_plain) <= TRAIN_LOSS_TOL):
        raise AssertionError(f"train: loss through the flash kernels "
                             f"{loss_kernel} vs plain mha {loss_plain}")
    emit("train", what="first micro-batch, flash kernels vs plain mha",
         loss_kernels=loss_kernel, loss_plain=loss_plain, tol=TRAIN_LOSS_TOL,
         card=name)

    counters = (TF.flash_fwd, TF.flash_bwd_dq, TF.flash_bwd_dkv)
    per_step = [2 * cfg.layers * TRAIN_ACCUM, cfg.layers * TRAIN_ACCUM,
                cfg.layers * TRAIN_ACCUM]
    for fn in counters:                 # the main path: counted from here
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    steps_done, step_ms = 0, []

    def run_step(tr, batch):
        nonlocal steps_done
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = tr.train(iter([batch]), 1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        steps_done += 1
        got = [fn.launches for fn in counters]
        if got != [n * steps_done for n in per_step]:
            raise AssertionError(f"train step {steps_done}: launches {got}, "
                                 f"expected {per_step} per step")
        loss, gnorm = metrics["loss"], metrics["grad_norm"]
        if not (math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0):
            raise AssertionError(f"train step {steps_done}: loss {loss}, "
                                 f"grad_norm {gnorm}")
        emit("train", step=tr.state.step, loss=loss, grad_norm=gnorm, ms=ms,
             launches=got, card=name)
        return loss, ms

    first = trainer()
    for i in range(2):
        _, ms = run_step(first, data[i])
        if i == 0:      # lr(0) = 0 under the warm-up: nothing moves
            for (path, a), (_, b) in zip(leaves_with_path(first.state.params),
                                         leaves_with_path(lora0)):
                if not torch.equal(a, b):
                    raise AssertionError(f"train: step 0 moved {path}")
        else:
            step_ms.append(ms)
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        mgr = CheckpointManager(tmp, max_to_keep=1)
        first.save_state(mgr)
        loss_continued, ms = run_step(first, data[2])
        step_ms.append(ms)
        second = trainer()
        if second.restore_state(mgr) != 2:
            raise AssertionError("train: restore_state did not find step 2")
    loss_resumed, ms = run_step(second, data[2])
    step_ms.append(ms)
    # the restored state is bit-identical and no kernel on the path uses
    # atomics; 1e-5 relative leaves room for a library matmul that splits K
    if not abs(loss_resumed - loss_continued) <= 1e-5 * abs(loss_continued):
        raise AssertionError(f"train: resumed loss {loss_resumed} vs "
                             f"continued {loss_continued}")

    if _fingerprint(base) != before:
        raise AssertionError("train: the frozen base changed")
    for path, t in leaves_with_path(first.state.params["adapters"]):
        if not t.isfinite().all() or (path.endswith("/b") and not t.any()):
            raise AssertionError(f"train: adapter {path} is zero or not finite")
    tokens = TRAIN_ACCUM * TRAIN_MICRO * TRAIN_SEQ
    median = statistics.median(step_ms)
    emit("train", what="SEED_LLAMA_8B + LoRA, grad_accum 2 x micro 4 x 1024, "
         "remat, flash kernels", optimizer_steps=steps_done,
         step_ms_median=median, step_ms_min=min(step_ms),
         step_ms_max=max(step_ms), step_ms_runs=step_ms,
         tokens_per_step=tokens, tokens_per_s=tokens / median * 1e3,
         max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         loss_continued=loss_continued, loss_resumed=loss_resumed,
         resumed_bit_equal=loss_resumed == loss_continued,
         launches_per_step=dict(zip(("flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv"), per_step)), card=name)
    return {fn.__name__: fn.launches for fn in counters}, median


# --------------------------------------------------------------- phase 9

# python3 -m seed_tpu_torch.train.train_llm at full width:
# SEED-LLaMA-8B + LoRA r=16, flash kernels, 8 sequences of 1024 tokens per
# step in 2 micro-batches of 4
LLM_ARGS = ["--model", "8b", "--lora", "--flash", "--batch-size", "8",
            "--grad-accum", "2", "--max-length", "1024", "--save-steps", "2",
            "--log-steps", "1", "--warmup", "1", "--seed", str(SEED + 6)]
WORDS = ("a photo of the red cat sitting on an old wooden table next to two "
         "small dogs in bright morning light while people walk by").split()


def _add(tf: tarfile.TarFile, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def write_llm_shards(root: Path) -> str:
    """Two pretokenized pkl shards of 32 records each (the extractor's
    format: 32 image ids, a caption, a question and answer). Captions of
    960-1100 bytes: with the byte tokenizer a caption example fills the
    1024-token sequence or nearly."""
    rs = np.random.RandomState(SEED + 7)
    for s in range(2):
        with tarfile.open(root / f"llm_{s:03d}.tar", "w") as tf:
            for i in range(32):
                n = int(rs.randint(960, 1100))
                text = " ".join(rs.choice(WORDS, n // 3))[:n]
                rec = {"image_ids": rs.randint(0, 8192, 32).tolist(),
                       "text": text, "question": f"what is in photo {i}?",
                       "answer": " ".join(rs.choice(WORDS, 8))}
                _add(tf, f"s{s}_k{i}.pkl", pickle.dumps(rec))
    return str(root / "llm_*.tar")


def write_llm_eval(root: Path):
    """Two pretokenized caption prompts (BOS, an image block, a prompt) and
    their reference captions."""
    from seed_tpu_torch.data import image_token_ids
    from seed_tpu_torch.serving.multimodal import ByteTextTokenizer
    tok = ByteTextTokenizer()
    rs = np.random.RandomState(SEED + 8)
    with open(root / "eval.jsonl", "w") as f:
        for i in range(2):
            ids = ([tok.bos_token_id] + image_token_ids(rs.randint(0, 8192, 32))
                   + tok.encode("Describe the image."))
            f.write(json.dumps({"input_ids": ids, "image_id": i}) + "\n")
    (root / "ann.json").write_text(json.dumps(
        {str(i): [" ".join(rs.choice(WORDS, 9))] for i in range(2)}))
    return ["--eval-data", str(root / "eval.jsonl"), "--eval-annotations",
            str(root / "ann.json"), "--eval-batches", "1",
            "--eval-batch-size", "2", "--eval-max-new-tokens", "16"]


def step_seconds(record: dict) -> list:
    """Host seconds of each logged step of an entry point's run record
    (logged every step; each line reads the loss, so the card has finished
    the step): from the round's start or from the previous step's line."""
    steps = [r["time"] for r in record["log"] if "loss" in r]
    marks = sorted(record["round_starts"] + steps)
    return [t - max(m for m in marks if m < t) for t in steps]


def _host_share(record: dict, seconds: list) -> dict:
    """The data pipeline's share of the training loop's wall: the seconds
    the loop waited for each batch against each step's wall. The first
    batch waits for the shuffle buffer to fill; the steady share leaves it
    out."""
    waits = record["data_waits_s"][:len(seconds)]
    return {"first_batch_wait_s": waits[0],
            "host_share": sum(waits) / sum(seconds),
            "host_share_steady": (sum(waits[1:]) / sum(seconds[1:])
                                  if len(seconds) > 1 else None)}


def phase_train_llm(name: str, synthetic_ms: float):
    """``train_llm`` on tar shards: 4 steps with a save at 2 and 4, then a
    fresh ``main(--resume)`` that restores step 4, trains step 5 and runs one
    caption eval round on the merged weights. Returns the flash kernels'
    launches over both runs, and the first run's losses and step times
    (phase 12 repeats its first steps under a mesh)."""
    from seed_tpu_torch.ops import flash_attention as TF
    from seed_tpu_torch.train import train_llm
    from seed_tpu_torch.utils.tree import leaves_with_path
    layers = train_llm.MODELS["8b"].layers
    counters = (TF.flash_fwd, TF.flash_bwd_dq, TF.flash_bwd_dkv)
    per_step = [4 * layers, 2 * layers, 2 * layers]   # grad_accum 2, remat
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        common = ["--data", write_llm_shards(tmp), *LLM_ARGS,
                  "--output", str(tmp / "out")]
        args = train_llm.parse_args(common + ["--steps", "4"])
        t0 = time.perf_counter()
        setup = train_llm.build(args)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        before = _fingerprint(setup.base)
        for fn in counters:             # the main path: counted from here
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        rec = train_llm.run(args, setup)
        got = [fn.launches for fn in counters]
        if got != [4 * n for n in per_step]:
            raise AssertionError(f"train_llm: launches {got}, expected "
                                 f"{per_step} per step for 4 steps")
        if _fingerprint(setup.base) != before:
            raise AssertionError("train_llm: the frozen base changed")
        losses = [r["loss"] for r in rec["log"] if "loss" in r]
        if len(losses) != 4 or not all(map(math.isfinite, losses)):
            raise AssertionError(f"train_llm: losses {losses}")
        for path, t in leaves_with_path(setup.trainer.state.params):
            if not t.isfinite().all() or (path.endswith("/b") and not t.any()):
                raise AssertionError(f"train_llm: adapter {path} is zero or "
                                     "not finite")
        seconds = step_seconds(rec)
        first_run = {"losses": losses, "step_ms": [x * 1e3 for x in seconds]}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        tokens = args.batch_size * args.max_length
        median = statistics.median(seconds[1:]) * 1e3
        emit("train_llm", what="SEED_LLAMA_8B + LoRA from tar shards "
             "(python3 -m seed_tpu_torch.train.train_llm " + " ".join(LLM_ARGS)
             + " --steps 4)", init_s=init_s, losses=losses,
             step_ms_runs=[x * 1e3 for x in seconds], step_ms_median=median,
             tokens_per_step=tokens, tokens_per_s=tokens / median * 1e3,
             synthetic_step_ms_median=synthetic_ms,
             max_memory_allocated_gib=peak, launches=got,
             **_host_share(rec, seconds), card=name)
        del setup
        torch.cuda.empty_cache()

        rec = train_llm.main(common + ["--steps", "5", "--resume",
                                       *write_llm_eval(tmp)])
        got = [fn.launches for fn in counters]
        if rec["resumed_from"] != 4 or rec["step"] != 5:
            raise AssertionError(f"train_llm --resume: from "
                                 f"{rec['resumed_from']} to {rec['step']}")
        if got != [5 * n for n in per_step]:
            raise AssertionError(f"train_llm --resume: launches {got}, "
                                 f"expected {per_step} per step for 5 steps")
        (ev,) = rec["evals"]
        loss = [r["loss"] for r in rec["log"] if "loss" in r]
        if not (math.isfinite(loss[0]) and ev["eval_num_evaluated"] == 2
                and all(math.isfinite(v) for v in ev.values())):
            raise AssertionError(f"train_llm --resume: loss {loss}, eval {ev}")
        emit("train_llm", what="a fresh main(--resume): step 4 restored, "
             "step 5 trained, one caption eval round on the merged weights",
             resumed_from=rec["resumed_from"], loss=loss[0],
             step_ms=step_seconds(rec)[0] * 1e3, eval=ev,
             launches_per_step=dict(zip((f.__name__ for f in counters),
                                        per_step)), card=name)
    return {fn.__name__: fn.launches for fn in counters}, first_run


# -------------------------------------------------------------- phase 10

# python3 -m seed_tpu_torch.train.train_tokenizer at full width: EVA-ViT-g
# (39 blocks, fp32, frozen) and the Q-Former with its text pathway; stage 2
# with the random CLIP-ViT-H target tower
TOK_ARGS = ["--arch", "full", "--image-size", "224", "--batch-size", "16",
            "--warmup", "1", "--seed", str(SEED + 9)]


def write_image_tar(root: Path, n: int = 48) -> str:
    """One webdataset tar of ``n`` JPEG + caption pairs: smooth colour
    fields with noise, 240-400 pixels a side."""
    from PIL import Image
    rs = np.random.RandomState(SEED + 10)
    with tarfile.open(root / "img_000.tar", "w") as tf:
        for i in range(n):
            h, w = (int(x) for x in rs.randint(240, 400, 2))
            yy, xx = np.mgrid[0:h, 0:w]
            base = np.stack([np.sin(xx / rs.uniform(8, 40) + c) * 90 + 128
                             + np.cos(yy / rs.uniform(8, 40)) * 30
                             for c in range(3)], -1)
            img = np.clip(base + rs.randn(h, w, 3) * 12, 0, 255).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="JPEG", quality=90)
            _add(tf, f"k{i}.jpg", buf.getvalue())
            _add(tf, f"k{i}.txt",
                 " ".join(rs.choice(WORDS, int(rs.randint(5, 16)))).encode())
    return str(root / "img_*.tar")


def _leaf_bits(tree, keep) -> dict:
    """Exact checksum of each leaf's bits whose path ``keep`` accepts."""
    from seed_tpu_torch.utils.tree import leaves_with_path
    return {p: _fingerprint(t) for p, t in leaves_with_path(tree) if keep(p)}


def _tokenizer_stage(name: str, stage: int, argv: list, metric_keys):
    """Build, train and check one stage; returns (record, trainable paths
    of the saved checkpoint, frozen paths)."""
    from seed_tpu_torch.ops.flash_attention import short_mha
    from seed_tpu_torch.train import train_tokenizer as TT
    from seed_tpu_torch.utils.checkpoint import filter_tree, restore_checkpoint
    from seed_tpu_torch.utils.tree import leaves_with_path
    args = TT.parse_args(argv)
    t0 = time.perf_counter()
    setup = TT.build(args)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    setup.trainer.cfg.log_every = 1
    trains = lambda p: re.search(setup.trainable, p) is not None
    frozen = _leaf_bits(setup.trainer.state.params, lambda p: not trains(p))
    n_params = {"trainable_params": 0, "frozen_params": 0}
    for p, t in leaves_with_path(setup.trainer.state.params):
        n_params["trainable_params" if trains(p) else "frozen_params"] += \
            t.numel()
    depth = setup.tok_cfg.vit.depth
    # stage 2's frozen bf16 CLIP tower (--arch full: CLIP-ViT-H) runs its
    # attention through short_mha too, one launch a block for each batch the
    # data thread prepares (it reads ahead)
    per_clip, clip_calls = 0, [0]
    if setup.clip is not None:
        from seed_tpu_torch.models.vit import CLIP_VIT_H
        per_clip, clip = CLIP_VIT_H.depth, setup.clip

        def counted(images):
            clip_calls[0] += 1
            return clip(images)
        setup.clip = counted
    launches0 = short_mha.launches
    torch.cuda.reset_peak_memory_stats()
    rec = TT.run(args, setup)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    got = short_mha.launches - launches0
    if got != depth * args.steps + per_clip * clip_calls[0]:
        raise AssertionError(f"train_tokenizer stage {stage}: short_mha "
                             f"launched {got} times, not {depth} per step "
                             f"and {per_clip} per CLIP batch "
                             f"({clip_calls[0]} batches)")
    logged = [r for r in rec["log"] if "loss" in r]
    for r in logged:
        if not all(math.isfinite(r[k]) for k in ("loss", *metric_keys)):
            raise AssertionError(f"train_tokenizer stage {stage}: {r}")
        if stage == 2 and not 0 < r["codebook_usage"] <= 1:
            raise AssertionError(f"codebook_usage {r['codebook_usage']}")
    if _leaf_bits(setup.trainer.state.params,
                  lambda p: not trains(p)) != frozen:
        raise AssertionError(f"train_tokenizer stage {stage}: a frozen leaf "
                             "changed")
    saved = restore_checkpoint(str(Path(args.output) / f"step_{args.steps}"),
                               device=setup.trainer.device)
    want = {p for p, _ in leaves_with_path(
        filter_tree(setup.trainer.state.params, setup.trainable))}
    if {p for p, _ in leaves_with_path(saved)} != want:
        raise AssertionError(f"train_tokenizer stage {stage}: the checkpoint "
                             "holds other paths than the trainable pattern")
    seconds = step_seconds(rec)
    median = statistics.median(seconds[1:])
    side = {}
    if setup.clip is not None:
        # the CLIP targets' device time per batch: work the data thread puts
        # on the card beside each step, on its own stream
        imgs = torch.randn((args.batch_size, args.image_size, args.image_size,
                            3), device="cuda")
        side["clip_targets_ms_per_batch"] = time_ms(lambda: setup.clip(imgs),
                                                    iters=5)
    emit("train_tokenizer", stage=stage, what="python3 -m "
         "seed_tpu_torch.train.train_tokenizer " + " ".join(argv[:-2]),
         init_s=init_s, step_ms_runs=[x * 1e3 for x in seconds],
         step_ms_median=median * 1e3,
         img_per_s=args.batch_size / median,
         metrics={k: [r[k] for r in logged] for k in ("loss", *metric_keys)},
         short_mha_launches=got, short_mha_launches_per_step=depth,
         clip_short_mha_launches_per_batch=per_clip,
         frozen_leaves=len(frozen), checkpoint_leaves=len(want), **n_params,
         max_memory_allocated_gib=peak, **_host_share(rec, seconds), **side,
         card=name)
    return got


def phase_train_tokenizer(name: str, flush: torch.Tensor, tmp: Path):
    """``train_tokenizer`` stage 1 (3 steps, saved under ``tmp``) then stage
    2 from that checkpoint (2 steps); then short_mha's fp32 launch at stage
    1's shape against its plain version and SDPA. Returns (launches over
    both stages, the fp32 record, the stages' common arguments)."""
    import torch.nn.functional as F
    from seed_tpu_torch.ops.flash_attention import short_mha, short_mha_plain
    launches = 0
    common = ["--data", write_image_tar(tmp), *TOK_ARGS]
    launches += _tokenizer_stage(
        name, 1, common + ["--stage", "1", "--steps", "3",
                           "--save-steps", "3", "--output", str(tmp / "s1")],
        ("itc", "itm", "lm"))
    torch.cuda.empty_cache()
    launches += _tokenizer_stage(
        name, 2, common + ["--stage", "2", "--steps", "2",
                           "--save-steps", "2", "--init-ckpt",
                           str(tmp / "s1" / "step_3"),
                           "--output", str(tmp / "s2")],
        ("vq", "recon", "distill", "codebook_usage"))
    torch.cuda.empty_cache()

    # row 1's fp32 instance at the stage-1 step's shape: the fast epilogue
    # (D = 88: the ones column), 2e-5 against its plain version; the exact
    # epilogue timed beside it
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    B, S, H, D = 16, 257, 16, 88
    q, k, v = _qkv_views(gen, B, S, H, D, torch.float32)
    before = short_mha.launches
    got = short_mha(q, k, v, D ** -0.5, False)
    err = (got - short_mha_plain(q, k, v, D ** -0.5, False)).abs().max().item()
    if not err <= 2e-5:
        raise AssertionError(f"short_mha fp32 stage-1 shape: {err} > 2e-5")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    bms, by = bound_ms(4 * B * S * H * D * 4, 4 * B * H * S * S * D, FP32_FLOPS)
    fp32 = dict(shape=dict(B=B, S=S, H=H, D=D, dtype="float32", exact=False),
                ms=time_ms(lambda: short_mha(q, k, v, D ** -0.5, False),
                           flush=flush),
                exact_ms=time_ms(lambda: short_mha(q, k, v, D ** -0.5, True),
                                 flush=flush),
                plain_ms=time_ms(lambda: short_mha_plain(q, k, v, D ** -0.5,
                                                         False), flush=flush),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt), flush=flush),
                bound_ms=bms, bound_by=by, max_abs_err=err)
    short_mha.launches = before          # comparison launches are not counted
    emit("kernels", kernel="short_mha", what="the stage-1 step's fp32 "
         "launch", **fp32, card=name)
    return launches, fp32, common


# -------------------------------------------------------------- phase 11

# Inception-v3 in fp32 on the card (TF32 off) against the same function on
# the CPU: the two differ only in the order of their sums, through about a
# hundred convolutions, within 1e-3 of the largest |feature|
INCEPTION_TOL = 1e-3
# codes per de-tokenizer call in the FID harness: a CFG batch of 4 through
# the UNet, whose level-0 attention scores take 2 GiB a pair
DECODE_BATCH = 2
VQA_QUESTIONS = ("What is the main colour of this picture?",
                 "How many objects can you see here?",
                 "Is this photo taken indoors or outdoors?",
                 "What is the texture on the left side of the image?")


def _sync_ms(fn):
    """(fn's result, its wall ms with the card synchronized)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_fid(name: str, tok_params, raw: torch.Tensor, codes: torch.Tensor,
              decoder) -> None:
    """11a. Reconstruction FID and IS of the de-tokenizer's pixels: the 8
    images encoded again (exact flash config), decoded to 768x768 by the
    bf16 unCLIP decoder (20 DDIM steps), against the originals' Inception
    pool3 features; Inception fp32 on the card against the CPU, and bf16."""
    from seed_tpu_torch.eval import (fid, generate_images_for_fid,
                                     inception_pool3, inception_probs,
                                     inception_score, init_inception)
    from seed_tpu_torch.models import seed_tokenizer as ST
    from seed_tpu_torch.models.layers import cast_tree
    from seed_tpu_torch.ops.preprocess import preprocess
    from seed_tpu_torch.utils.tree import tree_map
    inc = init_inception(torch.Generator(device="cuda").manual_seed(SEED + 12),
                         with_fc=True)
    n = raw.shape[0]
    real01 = raw.float() / 255.0
    with torch.inference_mode():
        again = ST.encode(tok_params, preprocess(raw, 224, torch.bfloat16),
                          _flash_cfg(ST.SEED_TOKENIZER, True))
    if not torch.equal(again, codes):
        raise AssertionError("FID: the real images' codes differ from phase "
                             "4's encode")
    inception_pool3(inc, real01)        # warm-up: cuDNN picks per shape
    real, real_ms = _sync_ms(lambda: inception_pool3(inc, real01))
    if real.shape != (n, 2048) or not real.isfinite().all():
        raise AssertionError(f"FID: bad real features {tuple(real.shape)}")
    want = inception_pool3(tree_map(lambda t: t.cpu(), inc),
                           real01[:DECODE_BATCH].cpu())
    scale = want.abs().max().item()
    rel = (real[:DECODE_BATCH].cpu() - want).abs().max().item() / scale
    if not (math.isfinite(rel) and rel <= INCEPTION_TOL):
        raise AssertionError(f"Inception fp32 card vs CPU: {rel} of the "
                             f"largest |feature| (bound {INCEPTION_TOL})")
    inc16 = cast_tree(inc, torch.bfloat16)
    inception_pool3(inc16, real01, dtype=torch.bfloat16)         # warm-up
    f16, bf16_ms = _sync_ms(lambda: inception_pool3(inc16, real01,
                                                    dtype=torch.bfloat16))
    rel16 = ((f16.float() - real).abs().max() / real.abs().max()).item()
    del inc16

    images, decode_ms = [], []

    def decode(c: np.ndarray) -> torch.Tensor:
        def run():
            with torch.inference_mode():
                emb = ST.decode_embedding(tok_params, torch.as_tensor(
                    c, device="cuda"), ST.SEED_TOKENIZER).float()
            return decoder.generate(emb)
        img, ms = _sync_ms(run)
        images.append(img)
        decode_ms.append(ms)
        return torch.from_numpy(img).cuda()

    fake = generate_images_for_fid(decode, codes.split(DECODE_BATCH),
                                   lambda x: inception_pool3(inc, x))
    pixels = torch.from_numpy(np.concatenate(images)).cuda()
    side = decoder.cfg.latent_size * decoder.cfg.vae.upscale
    if (fake.shape != (n, 2048) or not np.isfinite(fake).all()
            or pixels.shape != (n, side, side, 3)):
        raise AssertionError(f"FID: bad generated features {fake.shape} or "
                             f"pixels {tuple(pixels.shape)}")
    probs, probs_ms = _sync_ms(lambda: inception_probs(inc, pixels * 2 - 1))
    t0 = time.perf_counter()
    score = fid(real.cpu().numpy(), fake)
    fid_ms = (time.perf_counter() - t0) * 1e3
    is_mean, is_std = inception_score(probs.cpu().numpy(), splits=2)
    if not (math.isfinite(score) and score > -1e-3 and math.isfinite(is_mean)
            and is_mean >= 1.0 - 1e-4):
        raise AssertionError(f"FID {score}, IS {is_mean}")
    emit("eval", part="11a reconstruction FID / IS", images=n,
         what="raw -> encode (exact flash) -> decode_embedding -> unCLIP "
         "768x768 (bf16, offload, 20 DDIM steps) -> Inception pool3 "
         "(align-corners resize to 299) against the real pixels; IS over "
         "the antialiased 768 -> 299 logits, 2 splits; random weights",
         fid=score, inception_score=[is_mean, is_std],
         decode_ms_per_image=sum(decode_ms) / n,
         decode_ms_per_call=decode_ms,
         inception_pool3_ms_per_image_fp32=real_ms / n,
         inception_pool3_ms_per_image_bf16=bf16_ms / n,
         inception_probs_ms_per_image_768=probs_ms / n,
         host_fid_ms=fid_ms,
         fp32_card_vs_cpu_rel_err=rel, tol=INCEPTION_TOL,
         bf16_vs_fp32_rel_err=rel16, card=name)


def write_vqa_set(root: Path, raw: torch.Tensor) -> str:
    """8 JPEGs of the raw images and a VQA jsonl over them."""
    from PIL import Image
    root.mkdir(parents=True, exist_ok=True)
    with open(root / "vqa.jsonl", "w") as f:
        for i, img in enumerate(raw.cpu().numpy()):
            Image.fromarray(img).save(root / f"img_{i}.jpg", quality=90)
            f.write(json.dumps({
                "image": f"img_{i}.jpg", "question_id": 100 + i,
                "question": VQA_QUESTIONS[i % len(VQA_QUESTIONS)],
                "answer": ["red", "three", "outdoors", "noise"][i % 4]}) + "\n")
    return str(root / "vqa.jsonl")


def phase_vqa(name: str, params, tok_params, raw: torch.Tensor) -> None:
    """11b. VQA through SEED-LLaMA-8B int8: evaluate_vqa over a VQA jsonl
    and its JPEGs, each batch of 8 encoded (exact flash config) and
    answered in one batched generate (greedy, 8 new tokens)."""
    from seed_tpu_torch.eval import evaluate_vqa, vqa_eval_stream
    from seed_tpu_torch.models import llama as M
    from seed_tpu_torch.models import seed_tokenizer as ST
    from seed_tpu_torch.ops.int8_matmul import can_use_kernel, int8_matmul
    from seed_tpu_torch.ops.preprocess import preprocess
    from seed_tpu_torch.serving.engine import GenerationConfig, LlamaEngine
    from seed_tpu_torch.serving.multimodal import (ByteTextTokenizer,
                                                   SeedLlamaInterface)
    cfg = M.SEED_LLAMA_8B
    engine = LlamaEngine(params, cfg, max_len=512)
    iface = SeedLlamaInterface(engine, tok_params,
                               _flash_cfg(ST.SEED_TOKENIZER, True),
                               ByteTextTokenizer())
    gcfg = GenerationConfig(max_new_tokens=8, do_sample=False)
    calls = []

    def generate_fn(batch):
        pixels = torch.from_numpy(np.stack([r["pixels"] for r in batch]))
        codes = iface.encode_image(preprocess(pixels.cuda(), 224,
                                              torch.bfloat16))
        prompts = [iface.build_prompt([c, r["question"]])
                   for c, r in zip(codes, batch)]
        before = int8_matmul.launches
        outs, ms = _sync_ms(lambda: engine.generate(prompts, gcfg))
        m = len(prompts) * engine._bucket(max(len(p) for p in prompts))
        answers = ["".join(s.text for s in iface.split_output(o)
                           if s.kind == "text") for o in outs]
        calls.append(dict(prompts=len(prompts),
                          prompt_tokens=[len(p) for p in prompts],
                          prefill_m=m, int8_kernel=can_use_kernel(m, cfg.dim,
                                                                  cfg.dim),
                          int8_matmul_launches=int8_matmul.launches - before,
                          generate_ms=ms,
                          records=[{"question_id": r["question_id"],
                                    "answer": a}
                                   for r, a in zip(batch, answers)]))
        return answers

    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent
                                     / "build") as tmp:
        ann = write_vqa_set(Path(tmp), raw)
        scores = evaluate_vqa(generate_fn, vqa_eval_stream(ann, tmp, 224),
                              batch_size=8)
    if scores["num_evaluated"] != raw.shape[0] or len(calls) != 1:
        raise AssertionError(f"VQA: {scores}, {len(calls)} generate calls")
    if not (calls[0]["int8_kernel"] and calls[0]["prefill_m"] == VQA_PREFILL_M
            and calls[0]["int8_matmul_launches"] == 7 * cfg.layers + 1):
        raise AssertionError(f"VQA: the prefill (M = {calls[0]['prefill_m']},"
                             f" checked at {VQA_PREFILL_M}) did not take the "
                             f"int8 kernel {calls[0]['int8_matmul_launches']} "
                             "times")
    if not 0.0 <= scores["vqa_accuracy"] <= 1.0:
        raise AssertionError(f"VQA accuracy {scores['vqa_accuracy']}")
    emit("eval", part="11b VQA through SEED-LLaMA-8B int8",
         what="evaluate_vqa(vqa_eval_stream(jsonl + 8 JPEGs), batch 8): "
         "encode (exact flash) -> one batched greedy generate, 8 new tokens; "
         "random weights, so the score means nothing", **scores,
         generate=calls, card=name)


def phase_captions(name: str, tmp: Path, common: list, logger) -> None:
    """11c. The tokenizer's caption generators on phase 10's stage-1
    checkpoint (the full Q-Former, its BERT vocabulary and LM head; the
    frozen EVA-ViT-g from the run's seed), 16 images of the training tar,
    fp32, max_len 24: recompute and cached give the same tokens; scored
    with caption_metrics against the tar's captions."""
    import itertools
    from seed_tpu_torch.eval import caption_metrics
    from seed_tpu_torch.models import layers as L
    from seed_tpu_torch.models import qformer as Q
    from seed_tpu_torch.models import seed_tokenizer as ST
    from seed_tpu_torch.models.vit import vit_apply
    from seed_tpu_torch.ops.preprocess import preprocess
    from seed_tpu_torch.serving.multimodal import ByteTextTokenizer
    from seed_tpu_torch.train import train_tokenizer as TT
    from seed_tpu_torch.train.entry import generator
    from seed_tpu_torch.utils.checkpoint import merge_tree, restore_checkpoint
    from seed_tpu_torch.utils.metrics_logging import StepTimer
    args = TT.parse_args(common + ["--stage", "1", "--steps", "1",
                                   "--output", str(tmp / "captions")])
    ck = restore_checkpoint(str(tmp / "s1" / "step_3"))
    if not {"tokenizer", "lm_head"} <= set(ck):
        raise AssertionError(f"stage-1 checkpoint holds {sorted(ck)}")
    base = ST.SEED_TOKENIZER
    cfg = dataclasses.replace(
        base, vit=dataclasses.replace(base.vit, use_flash=True),
        qformer=dataclasses.replace(base.qformer, with_text=True))
    tok = merge_tree(ST.init_seed_tokenizer(generator(torch.device("cuda"),
                                                      args.seed), cfg),
                     ck["tokenizer"])
    recs = list(itertools.islice(TT.example_stream(args), 16))
    text = ByteTextTokenizer()
    with torch.inference_mode():
        imgs = preprocess(torch.from_numpy(np.stack(
            [r["pixels"] for r in recs])).cuda(), 224, torch.float32)
        feats = L.layer_norm(tok["ln_vision"],
                             vit_apply(tok["vit"], imgs, cfg.vit))
    qcfg = cfg.qformer
    if ck["lm_head"]["bias"].shape != (qcfg.vocab_size,) or \
            qcfg.vocab_size != 30523:
        raise AssertionError("captions: the LM head is not the BERT vocabulary")
    timer = StepTimer()
    tokens = {}
    for label, fn in (("recompute", Q.qformer_generate_caption),
                      ("cached", Q.qformer_generate_caption_cached)):
        for _ in range(2):                 # the second run is timed
            timer.start()
            tokens[label] = fn(tok["qformer"], ck["lm_head"], feats, qcfg,
                               text.bos_token_id, text.eos_token_id, 24)
            ms = timer.stop(sync=tokens[label]) * 1e3
        logger.update(**{f"caption_{label}_ms": ms})
    a, b = tokens["recompute"], tokens["cached"]
    if a.shape != (16, 24) or a.dtype != torch.int32 or not torch.equal(a, b):
        raise AssertionError("captions: cached and recompute tokens differ")
    captions = [text.decode(row[1:].tolist()) for row in a]
    scores = caption_metrics(
        [{"image_id": i, "caption": c} for i, c in enumerate(captions)],
        {i: [r["text"]] for i, r in enumerate(recs)})
    logger.write_json_line(part="11c", **scores)
    emit("eval", part="11c tokenizer captions",
         what="qformer_generate_caption and _cached on phase 10's stage-1 "
         "checkpoint (full Q-Former, 30,523-word LM head), 16 images, fp32, "
         "max_len 24, greedy", identical_tokens=True,
         recompute_ms=logger.meters["caption_recompute_ms"].global_avg,
         cached_ms=logger.meters["caption_cached_ms"].global_avg,
         caption_metrics=scores, first_caption=captions[0], card=name)


def dvm_trainer(gen: torch.Generator):
    """The discrete vision model at DVMConfig() on the frozen, random
    CLIP-ViT-H tower with its projection (bf16, mha), the trainable parts
    in fp32, AdamW through Trainer. Returns (cfg, trainer)."""
    from seed_tpu_torch.models import discrete_vision as DV
    from seed_tpu_torch.models.vit import (CLIP_VIT_H,
                                           init_clip_vision_projection,
                                           init_vit)
    from seed_tpu_torch.train.optim import adamw, masked_trainable
    from seed_tpu_torch.train.trainer import Trainer
    cfg = DV.DVMConfig()
    params = {"dvm": DV.init_dvm(gen, cfg),
              "tower": init_vit(gen, CLIP_VIT_H, torch.bfloat16),
              "head": init_clip_vision_projection(gen, CLIP_VIT_H,
                                                  cfg.proj_dim,
                                                  torch.bfloat16)}

    def loss_fn(p, batch, rng):
        total, m = DV.dvm_loss(p["dvm"], p["tower"], p["head"],
                               batch["images"], cfg, CLIP_VIT_H)
        return total, {k: m[k] for k in ("loss_rec", "loss_quant",
                                         "loss_iti")}

    tx = masked_trainable(adamw(lambda step: 1e-4, b2=0.999,
                                weight_decay=0.05), params, r"^dvm/")
    return cfg, Trainer(loss_fn, params, tx)


def phase_dvm(name: str, logger) -> None:
    """11d. The discrete vision model: 3 timed Trainer steps of dvm_loss at
    DVMConfig() on CLIP-ViT-H (batch 16 at 224) and a fourth under
    profile_trace, timed apart; then 3 steps of dvm_clip_embed_loss (transformer
    encoder, norm-EMA codebook from kmeans_init_codebook, norm_ema_update
    after each step)."""
    from seed_tpu_torch.models import discrete_vision as DV
    from seed_tpu_torch.models import quantizer as Q
    from seed_tpu_torch.models.layers import count_params
    from seed_tpu_torch.models.vit import CLIP_VIT_H, clip_image_embed
    from seed_tpu_torch.train.optim import adamw, masked_trainable
    from seed_tpu_torch.train.trainer import Trainer
    from seed_tpu_torch.utils.metrics_logging import StepTimer, profile_trace
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, trainer = dvm_trainer(gen)
    params = trainer.state.params
    frozen = {k: _fingerprint(params[k]) for k in ("tower", "head")}
    imgs = torch.randn((16, 224, 224, 3), generator=gen,
                       device="cuda").to(torch.bfloat16)
    timer, step_ms, losses = StepTimer(), [], []

    def step(i):
        timer.start()
        m = trainer.step({"images": imgs})
        ms = timer.stop(sync=m["loss"]) * 1e3
        m = {k: float(v) for k, v in m.items()}
        losses.append(m)
        logger.update(**{f"dvm_{k}": v for k, v in m.items()})
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"DVM step {i}: {m}")
        return ms

    for i in range(3):
        step_ms.append(step(i))
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent
                                     / "build") as trace_dir:
        with profile_trace(trace_dir):
            profiled_ms = step(3)
        traces = list(Path(trace_dir).glob("trace_*.json"))
        if len(traces) != 1:
            raise AssertionError(f"DVM: profile_trace wrote {len(traces)} "
                                 "traces, not 1")
        trace_bytes = traces[0].stat().st_size
    for k in ("tower", "head"):
        if _fingerprint(trainer.state.params[k]) != frozen[k]:
            raise AssertionError(f"DVM: the frozen {k} changed")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    logger.write_json_line(part="11d dvm_loss")
    emit("eval", part="11d discrete vision model, dvm_loss",
         what="DVMConfig() (4 + 4 blocks of 1280, 8192 x 32 codebook, fp32) "
         "on the frozen random CLIP-ViT-H (32 blocks of 1280, bf16, mha) "
         "with its projection, batch 16 at 224, AdamW, 3 timed Trainer "
         "steps, then a fourth under profile_trace", step_ms=step_ms,
         profiled_step_ms=profiled_ms, losses=losses,
         trainable_params=count_params(params["dvm"]),
         frozen_params=count_params(params["tower"]) + count_params(
             params["head"]), frozen_bit_identical=True,
         trace_bytes=trace_bytes,
         max_memory_allocated_gib=peak, card=name)

    # the FroClipEmbed variant on the same tower's pooled embeddings
    with torch.no_grad():
        embeds = clip_image_embed(params["tower"], params["head"], imgs,
                                  CLIP_VIT_H).float()
    del trainer, params
    torch.cuda.empty_cache()
    ecfg = DV.ClipEmbedDVMConfig(encoder="transformer", quantizer="norm_ema")
    p = DV.init_clip_embed_dvm(gen, ecfg)
    with torch.no_grad():
        _, m0 = DV.dvm_clip_embed_loss(p, embeds, ecfg)
    cb = Q.kmeans_init_codebook(gen, m0["z"].reshape(-1, ecfg.code_dim),
                                ecfg.n_codes)
    p["vq"] = {"codebook": cb, "cluster_size": p["vq"]["cluster_size"],
               "embed_avg": cb.clone()}
    last = {}

    def loss_fn(params, batch, rng):
        total, m = DV.dvm_clip_embed_loss(params, batch["embeds"], ecfg)
        last.update(z=m["z"].detach(), indices=m["indices"])
        return total, {"loss_rec": m["loss_rec"],
                       "loss_quant": m["loss_quant"]}

    usage = lambda idx: idx.unique().numel() / ecfg.n_codes
    with torch.no_grad():
        usage_before = usage(DV.dvm_clip_embed_loss(p, embeds, ecfg)[1]
                             ["indices"])
    tx = masked_trainable(adamw(lambda step: 1e-4, b2=0.999), p,
                          r"^(quant_encoder|encode_task|decode_task|"
                          r"quant_decoder)/")
    trainer = Trainer(loss_fn, p, tx)
    step_ms, losses = [], []
    for i in range(3):
        timer.start()
        m = trainer.step({"embeds": embeds})
        trainer.state.params["vq"] = Q.norm_ema_update(
            trainer.state.params["vq"], last["z"], last["indices"])
        step_ms.append(timer.stop(sync=trainer.state.params["vq"]
                                  ["codebook"]) * 1e3)
        losses.append({k: float(v) for k, v in m.items()})
        logger.update(**{f"embed_dvm_{k}": v for k, v in losses[-1].items()})
        if not all(math.isfinite(v) for v in losses[-1].values()):
            raise AssertionError(f"embed DVM step {i}: {losses[-1]}")
    cb = trainer.state.params["vq"]["codebook"]
    if not (cb.isfinite().all() and torch.allclose(
            cb.norm(dim=-1), torch.ones_like(cb[:, 0]), atol=1e-4)):
        raise AssertionError("embed DVM: the codebook left the unit sphere")
    with torch.no_grad():
        usage_after = usage(DV.dvm_clip_embed_loss(
            trainer.state.params, embeds, ecfg)[1]["indices"])
    logger.write_json_line(part="11d dvm_clip_embed_loss")
    emit("eval", part="11d discrete vision model, dvm_clip_embed_loss",
         what="ClipEmbedDVMConfig(encoder='transformer', quantizer="
         "'norm_ema') on the 16 pooled CLIP-ViT-H embeddings; codebook from "
         "kmeans_init_codebook over their z; 3 Trainer steps, "
         "norm_ema_update after each", step_ms=step_ms, losses=losses,
         code_usage_before=usage_before, code_usage_after=usage_after,
         logged=str(logger), card=name)
    del trainer, p, embeds
    torch.cuda.empty_cache()


# -------------------------------------------------------------- phase 12

def _same_bits(a, b) -> bool:
    from seed_tpu_torch.utils.tree import leaves_with_path
    la, lb = leaves_with_path(a), leaves_with_path(b)
    return ([p for p, _ in la] == [p for p, _ in lb] and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for (_, x), (_, y) in zip(la, lb)))


def phase_parallel(name: str, phase9: dict) -> dict:
    """12a: a one-rank NCCL group on the card. ``train_llm --tp 1`` on phase
    9's shards and seed, which under the group goes through the mesh Trainer
    with LLAMA_TP_RULES (DTensor state): four steps through the flash
    kernels, the first loss against phase 9's, the median of the three
    steady steps beside phase 9's, the save at step 4 restored into a
    Trainer without a mesh; then ring attention and the GPipe schedule at
    the 8B layer's shapes against mha and the unpipelined layers. Returns
    the flash kernels' launches of the four steps."""
    import datetime
    import torch.distributed as dist
    from seed_tpu_torch import parallel as TP
    from seed_tpu_torch.models import llama as TM
    from seed_tpu_torch.ops import flash_attention as TF
    from seed_tpu_torch.ops.attention import mha, sliced_causal_mask
    from seed_tpu_torch.parallel.mesh import use_mesh
    from seed_tpu_torch.parallel.partition import full_tree
    from seed_tpu_torch.train import train_llm
    from seed_tpu_torch.train.trainer import Trainer
    from seed_tpu_torch.utils.checkpoint import CheckpointManager
    layers = TM.SEED_LLAMA_8B.layers
    counters = (TF.flash_fwd, TF.flash_bwd_dq, TF.flash_bwd_dkv)
    per_step = [4 * layers, 2 * layers, 2 * layers]   # grad_accum 2, remat
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        dist.init_process_group(
            "nccl", store=dist.FileStore(str(tmp / "store"), 1), rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=300))
        try:
            mesh = TP.make_mesh(1, 1, 1, 1, device_type="cuda")
            common = ["--data", write_llm_shards(tmp), *LLM_ARGS, "--tp", "1",
                      "--output", str(tmp / "out")]
            args = train_llm.parse_args(common + ["--steps", "4"])
            t0 = time.perf_counter()
            setup = train_llm.build(args)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            if setup.trainer.mesh is None:
                raise AssertionError("parallel: train_llm under a process "
                                     "group built no mesh")
            for fn in counters:             # the main path: counted from here
                fn.launches = 0
            rec = train_llm.run(args, setup)
            got = [fn.launches for fn in counters]
            if got != [4 * n for n in per_step]:
                raise AssertionError(f"parallel: launches {got}, expected "
                                     f"{per_step} per step for 4 steps")
            losses = [r["loss"] for r in rec["log"] if "loss" in r]
            ref = phase9["losses"][0]
            diff = abs(losses[0] - ref)
            if not (losses[0] == ref or diff <= 1e-3 * abs(ref)):
                raise AssertionError(f"parallel: first loss {losses[0]} vs "
                                     f"phase 9's {ref} (diff {diff})")
            # the save at step 4 restores into a Trainer without a mesh
            saved = full_tree({"params": setup.trainer.state.params,
                               "opt_state": setup.trainer.state.opt_state})
            plain = Trainer(lambda p, b, r: None, saved["params"],
                            setup.trainer.optimizer, device="cuda")
            step = plain.restore_state(CheckpointManager(str(tmp / "out" /
                                                             "state")))
            if step != 4 or not _same_bits(
                    {"params": plain.state.params,
                     "opt_state": plain.state.opt_state}, saved):
                raise AssertionError("parallel: the mesh state restored into "
                                     "a Trainer without a mesh differs")
            # steps 2-4 of both runs: the first holds the shuffle buffer's
            # fill (and, under the mesh, sharding propagation's first pass)
            step_ms = [x * 1e3 for x in step_seconds(rec)]
            median = statistics.median(step_ms[1:])
            median9 = statistics.median(phase9["step_ms"][1:])
            emit("parallel", what="train_llm --tp 1 on a one-rank NCCL mesh "
                 "(data, fsdp, pipe, tensor) = (1, 1, 1, 1): the mesh Trainer, "
                 "DTensor state by LLAMA_TP_RULES, phase 9's shards and seed",
                 init_s=init_s, losses=losses, phase9_losses=phase9["losses"],
                 first_loss_diff=diff, first_loss_rel_diff=diff / abs(ref),
                 step_ms_runs=step_ms, phase9_step_ms_runs=phase9["step_ms"],
                 steady_step_ms_median=median,
                 phase9_steady_step_ms_median=median9,
                 mesh_over_plain=median / median9, launches=got,
                 restored_step=step, restore_bit_equal=True, card=name)
            del setup, plain, saved
            torch.cuda.empty_cache()

            # ring attention and GPipe at the 8B layer's shapes, one rank
            cfg = TM.SEED_LLAMA_8B
            B, S, H, D = 1, 1024, cfg.heads, cfg.head_dim
            gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
            q, k, v = (torch.randn(B, S, H, D, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(3))
            mask = sliced_causal_mask(S, S, 0, "cuda")
            with torch.no_grad():
                ring = lambda: TP.sequence_parallel_attention(q, k, v, mesh,
                                                              axis="data")
                want = mha(q, k, v, mask=mask).float()
                err = (ring().float() - want).abs().max().item()
                tol = want.abs().max().item() / 64
                if not err <= tol:
                    raise AssertionError(f"ring_attention vs mha: {err} > {tol}")
                ring_ms = time_ms(ring, iters=5)
                mha_ms = time_ms(lambda: mha(q, k, v, mask=mask), iters=5)
                lps = [TM.init_layer(gen, cfg, torch.bfloat16, "cuda")
                       for _ in range(2)]
                x_mb = torch.randn(2, B, S, cfg.dim, generator=gen,
                                   device="cuda").to(torch.bfloat16)
                positions = torch.arange(S, device="cuda")
                layer_fn = lambda lp, h: TM.layer_apply(lp, h, positions, mask,
                                                        cfg)
                with use_mesh(mesh):
                    piped = TP.pipeline_forward(layer_fn, lps, x_mb, axis="pipe")
                plain_out = []
                for h in x_mb:
                    for lp in lps:
                        h = layer_fn(lp, h)
                    plain_out.append(h)
                pipe_err = (piped.float() - torch.stack(plain_out).float()
                            ).abs().max().item()
                if pipe_err != 0.0:
                    raise AssertionError(f"pipeline_forward vs the layers: "
                                         f"{pipe_err}")
            emit("parallel", what="ring_attention (sequence_parallel_attention "
                 "over 'data') and pipeline_forward (2 microbatches, 2 layers) "
                 "on one rank at B=1 S=1024 H=32 D=128 bf16",
                 ring_vs_mha_max_abs_err=err, ring_tolerance=tol,
                 ring_ms=ring_ms, mha_ms=mha_ms,
                 pipeline_vs_layers_max_abs_err=pipe_err,
                 pipeline_tolerance=0.0, card=name)
            del q, k, v, lps, x_mb, piped, plain_out
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    return dict(zip((fn.__name__ for fn in counters), got))


def phase_extract_image_ids(name: str) -> None:
    """12b: ``python3 -m seed_tpu_torch.data.extract_image_ids`` at full
    width (SEED_TOKENIZER, bf16, --batch-size 16) on a tar of 160 JPEGs
    made as phase 10's: img/s over the whole loop and over the 9 batches
    after the first (the warm rate); the shards' ids against the same encode in
    process on the same decoded pixels; the shards read back and made into
    a caption example."""
    from seed_tpu_torch import native
    from seed_tpu_torch.data import build_caption_example, tar_source
    from seed_tpu_torch.data.extract_image_ids import pixel_batches
    from seed_tpu_torch.models import seed_tokenizer as ST
    from seed_tpu_torch.ops.preprocess import preprocess
    from seed_tpu_torch.serving.multimodal import ByteTextTokenizer
    built = native.available()
    emit("extract_image_ids", native_loader_built=built,
         native_build_error=native.build_error(), card=name)
    root = Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root / "build") as tmp:
        tmp = Path(tmp)
        images = write_image_tar(tmp, n=160)
        cmd = [sys.executable, "-m", "seed_tpu_torch.data.extract_image_ids",
               "--input", images, "--output", str(tmp / "ids"),
               "--batch-size", "16", "--device", "cuda"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=root,
                              timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError("extract_image_ids failed:\n"
                                 + proc.stderr[-4000:])
        m = re.search(r"done: (\d+) images in ([\d.]+)s \((\w+) loader, "
                      r"waited ([\d.]+)s", proc.stdout)
        n, seconds, loader, waited = (int(m[1]), float(m[2]), m[3],
                                      float(m[4]))
        w = re.search(r"after the first batch: (\d+) images in ([\d.]+)s "
                      r"\(waited ([\d.]+)s", proc.stdout)
        warm_n, warm_s, warm_wait = int(w[1]), float(w[2]), float(w[3])
        if n != 160 or warm_n != 144 or loader != ("native" if built
                                                    else "python"):
            raise AssertionError(f"extract_image_ids: {n} images through the "
                                 f"{loader} loader")
        records = {r["__key__"]: r for r in
                   tar_source(str(tmp / "ids" / "host0_*.tar"))}
        # the same encode in process, on the same decoded pixels
        params = ST.init_seed_tokenizer(
            torch.Generator(torch.device("cuda")).manual_seed(0),
            ST.SEED_TOKENIZER, torch.bfloat16, torch.device("cuda"))
        _, batches = pixel_batches(images, 16, 224)
        pil_diff = []
        try:
            for batch in batches:
                pixels = np.stack([b["pixels"] for b in batch])
                with torch.inference_mode():
                    ids = ST.encode(params, preprocess(
                        torch.from_numpy(pixels).cuda(), 224, torch.bfloat16),
                        ST.SEED_TOKENIZER).cpu().numpy()
                for b, row in zip(batch, ids):
                    if records[b["__key__"]]["image_ids"] != row.tolist():
                        raise AssertionError(f"extract_image_ids: ids of "
                                             f"{b['__key__']} differ")
                if loader == "native":
                    pil_diff += _pil_mean_diff(
                        images.replace("img_*.tar", "img_000.tar"), batch)
        finally:
            batches.close()
        if pil_diff and not max(pil_diff) < 12.0:
            raise AssertionError(f"native decode vs PIL: {max(pil_diff)}")
        rec = records[sorted(records)[0]]
        ex = build_caption_example(rec, ByteTextTokenizer(), 128,
                                   reverse_ratio=0.0)
        if ex is None or len(ex["input_ids"]) != 128 or not any(
                32000 <= t < 40192 for t in ex["input_ids"]):
            raise AssertionError("extract_image_ids: no caption example")
        emit("extract_image_ids", what="python3 -m seed_tpu_torch.data."
             "extract_image_ids --batch-size 16 (SEED_TOKENIZER bf16) on 160 "
             "JPEGs; warm: the 144 after the first batch", loader=loader,
             images=n, encode_loop_s=seconds, img_per_s=n / seconds,
             loader_wait_s=waited, loader_share=waited / seconds,
             warm_images=warm_n, warm_s=warm_s, warm_img_per_s=warm_n / warm_s,
             warm_loader_wait_s=warm_wait, warm_loader_share=warm_wait / warm_s,
             process_wall_s=wall,
             ids_equal_in_process=True, native_vs_pil_mean_abs=(
                 max(pil_diff) if pil_diff else None),
             shards=len(list((tmp / "ids").glob("*.tar"))),
             caption_example_tokens=len(ex["input_ids"]), card=name)


def _pil_mean_diff(path: str, batch) -> list:
    """Mean |native - PIL| of each image of a native batch (PIL's resize of
    the same JPEG of the tar at ``path``)."""
    from PIL import Image
    out = []
    with tarfile.open(path) as tf:
        for b in batch:
            data = tf.extractfile(b["__key__"] + ".jpg").read()
            pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB")
                             .resize(b["pixels"].shape[:2][::-1]), np.float32)
            out.append(float(np.abs(b["pixels"].astype(np.float32) - pil).mean()))
    return out


# -------------------------------------------------------------- phase 13

# The merge runs at the 8B's width with its depth cut to 4 of 32 layers: the
# merge is the same per layer, and the full depth would write and read three
# 13.5 GB trees (base, merged, the merged read back) for nothing it does
# differently.
MERGE_LAYERS = 4


def write_jpeg(path: Path, seed: int, h: int = 300, w: int = 400) -> None:
    """A seeded RGB JPEG: smooth colour ramps with noise on top."""
    from PIL import Image
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    ramps = np.stack([xx / w, yy / h, (xx + yy) / (h + w)], -1) * 200
    img = np.clip(ramps + rs.randint(0, 56, (h, w, 3)), 0, 255)
    Image.fromarray(img.astype(np.uint8)).save(path, quality=90)


def _peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2 ** 30


def _blocks(ids) -> list:
    """The well-formed image blocks of a generated stream, parsed apart from
    split_output: BOI, 32 codes in range, EOI."""
    from seed_tpu_torch import (BOI_TOKEN_ID, EOI_TOKEN_ID, IMAGE_ID_SHIFT,
                                NUM_IMG_CODES, NUM_IMG_TOKENS)
    out, i = [], 0
    while i < len(ids):
        if ids[i] == BOI_TOKEN_ID and EOI_TOKEN_ID in ids[i + 1:]:
            j = ids.index(EOI_TOKEN_ID, i + 1)
            codes = [t - IMAGE_ID_SHIFT for t in ids[i + 1:j]]
            if (len(codes) == NUM_IMG_TOKENS
                    and all(0 <= c < NUM_IMG_CODES for c in codes)):
                out.append(codes)
                i = j + 1
                continue
        i += 1
    return out


def scripts_llama(name: str, jpeg: Path) -> int:
    """seed_llama_inference --model 8b: SEED-LLaMA-8B bf16 at full width and
    depth, the full SEED tokenizer, the three prompts sampled; then the same
    with one new token, whose seconds are each prompt's prefill. Returns
    the bf16 encodes run (one a command)."""
    from seed_tpu_torch import BOI_TOKEN_ID
    from seed_tpu_torch.scripts import seed_llama_inference as SLI
    argv = ["--model", "8b", "--image", str(jpeg)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = SLI.main(argv + ["--max-new-tokens", "64"])
    total_s = time.perf_counter() - t0
    peak = _peak_gib()
    gc_collect()
    first = SLI.main(argv + ["--max-new-tokens", "1"])
    gc_collect()
    if [r["task"] for r in results] != [r["task"] for r in first]:
        raise AssertionError("seed_llama_inference: the runs' tasks differ")
    for r, r1 in zip(results, first):
        ids = list(r["ids"])
        images = [s for s in r["segments"] if s.kind == "image"]
        blocks = _blocks(ids)
        if r["forced"] and ids[0] != BOI_TOKEN_ID:
            raise AssertionError(f"{r['task']}: the block was not forced "
                                 f"({ids[:4]})")
        if ([s.image_codes[0].tolist() for s in images] != blocks
                or any(s.image_codes.shape != (1, 32) for s in images)):
            raise AssertionError(f"{r['task']}: image segments "
                                 f"{[s.image_codes.shape for s in images]} "
                                 f"against {len(blocks)} well-formed blocks")
        n = len(ids)
        decode_s = r["seconds"] - r1["seconds"]
        emit("scripts", what="python3 -m seed_tpu_torch.scripts."
             "seed_llama_inference --model 8b --max-new-tokens 64 (bf16, 32 "
             "layers, seeded weights, sampled top_p 0.5)", task=r["task"],
             forced=r["forced"], tokens=n, seconds=r["seconds"],
             prefill_seconds=r1["seconds"],
             decode_tok_per_s=(n - 1) / decode_s if n > 1 else None,
             well_formed_blocks=len(blocks), image_segments=len(images),
             text_chars=sum(len(s.text or "") for s in r["segments"]),
             card=name)
    emit("scripts", what="seed_llama_inference --model 8b: the whole command "
         "(seeded init of the 8B and the SEED tokenizer, encode, 3 prompts)",
         seconds=total_s, peak_gib=peak, card=name)
    return 2


def scripts_tokenizer(name: str, jpeg: Path, tmp: Path) -> int:
    """seed_tokenizer_inference with an SD2.1 unCLIP checkpoint written
    here (seeded, bf16): ids, the 768x768 JPEG, and the ids against the
    interface's encode of the same bytes in process. Returns the bf16
    encodes run."""
    from PIL import Image
    from seed_tpu_torch.models import seed_tokenizer as ST
    from seed_tpu_torch.models.unclip import SD21_UNCLIP, init_unclip
    from seed_tpu_torch.ops.preprocess import preprocess
    from seed_tpu_torch.scripts import seed_tokenizer_inference as STI
    from seed_tpu_torch.scripts.seed_llama_inference import read_image
    from seed_tpu_torch.serving.multimodal import SeedLlamaInterface
    from seed_tpu_torch.utils.checkpoint import save_checkpoint
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    t0 = time.perf_counter()
    save_checkpoint(tmp / "unclip", init_unclip(gen, SD21_UNCLIP,
                                                torch.bfloat16))
    write_s = time.perf_counter() - t0
    gc_collect()
    out = tmp / "reconstruction.jpg"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = STI.main(["--image", str(jpeg), "--diffusion-ckpt",
                    str(tmp / "unclip"), "--save", str(out)])
    seconds = time.perf_counter() - t0
    peak = _peak_gib()
    back = np.asarray(Image.open(out))
    side = SD21_UNCLIP.latent_size * SD21_UNCLIP.vae.upscale
    if back.shape != (side, side, 3) or res["image"].shape != back.shape:
        raise AssertionError(f"seed_tokenizer_inference: {out} reads back "
                             f"as {back.shape}")
    del res["embedding"]
    gc_collect()
    # the same bytes through the interface, in process
    params = ST.init_seed_tokenizer(
        torch.Generator(device="cuda").manual_seed(0), ST.SEED_TOKENIZER,
        torch.bfloat16)
    iface = SeedLlamaInterface(None, params, ST.SEED_TOKENIZER)
    raw = read_image(str(jpeg), "cuda")
    want = iface.encode_image(preprocess(raw, 224, torch.bfloat16))
    if not np.array_equal(res["ids"], want):
        raise AssertionError(f"seed_tokenizer_inference ids {res['ids']} != "
                             f"SeedLlamaInterface.encode_image {want}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        STI.tokenize(params, raw, ST.SEED_TOKENIZER)
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) / reps * 1e3
    emit("scripts", what="python3 -m seed_tpu_torch.scripts."
         "seed_tokenizer_inference --diffusion-ckpt (SD2.1 unCLIP, seeded "
         "bf16, 20 DDIM steps, guidance 10)", ids=res["ids"][0].tolist(),
         ids_equal_encode_image=True,
         encode_and_embedding_ms=encode_ms,
         seconds_to_jpeg=seconds, unclip_checkpoint_write_seconds=write_s,
         jpeg=list(back.shape), peak_gib=peak, card=name)
    del params, iface
    return 2 + reps     # the command, the interface, the timed tokenizes


def scripts_merge(name: str, tmp: Path) -> None:
    """merge_lora on train_llm --lora's {"lora"} save and a bare base at the
    8B's width, MERGE_LAYERS deep: the saved tree equals the merge in
    memory, and the inputs are left as they were."""
    from seed_tpu_torch.models import llama as M
    from seed_tpu_torch.scripts import merge_lora as ML
    from seed_tpu_torch.train.lora import init_lora, merge_lora_weights
    from seed_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                 save_checkpoint)
    from seed_tpu_torch.utils.tree import leaves, tree_map
    cfg = dataclasses.replace(M.SEED_LLAMA_8B, layers=MERGE_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    base = M.init_llama(gen, cfg, torch.bfloat16)
    lora = init_lora(gen, base, r=16, alpha=32)
    for ad in lora["adapters"].values():   # trained adapters: B is not zero
        ad["b"].normal_(0.0, 0.02, generator=gen)
    save_checkpoint(tmp / "base", base)
    save_checkpoint(tmp / "lora", {"lora": lora})
    copies = tree_map(torch.clone, {"base": base, "lora": lora})
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ML.main(["--base", str(tmp / "base"), "--lora", str(tmp / "lora"),
             "--output", str(tmp / "merged")])
    seconds = time.perf_counter() - t0
    want = merge_lora_weights(base, lora)
    got = restore_checkpoint(tmp / "merged")
    if not _same_bits(got, want):
        raise AssertionError("merge_lora: the saved tree differs from "
                             "merge_lora_weights in memory")
    if not _same_bits(copies, {"base": base, "lora": lora}):
        raise AssertionError("merge_lora: the merge changed its inputs")
    changed = not torch.equal(got["layers"][0]["q_proj"]["kernel"],
                              base["layers"][0]["q_proj"]["kernel"])
    gib = sum(t.numel() * t.element_size() for t in leaves(base)) / 2 ** 30
    emit("scripts", what="python3 -m seed_tpu_torch.scripts.merge_lora on a "
         "train_llm --lora {'lora'} save and a bare base",
         reduced=f"SEED-LLaMA-8B width, {MERGE_LAYERS} of 32 layers: the "
         "merge is the same per layer, the full depth writes and reads three "
         "13.5 GB trees for nothing it does differently",
         seconds=seconds, tree_gib=gib, adapted_kernels=len(lora["adapters"]),
         merged_equals_in_memory=True, inputs_bit_identical=True,
         kernels_changed=changed, peak_gib=_peak_gib(), card=name)
    del base, lora, copies, want, got


def scripts_acceptance(name: str, tmp: Path) -> None:
    """acceptance --synthetic on the card: exit 0, every stage's status."""
    from seed_tpu_torch.scripts import acceptance as A
    out = tmp / "acceptance"
    t0 = time.perf_counter()
    try:
        A.main(["--synthetic", "--device", "cuda", "--out", str(out),
                "--max-images", "2", "--max-new-tokens", "8",
                "--diffusion-steps", "2"])
        code = 0
    except SystemExit as e:
        code = e.code
    seconds = time.perf_counter() - t0
    report = json.loads((out / "acceptance.json").read_text())
    stages = {k: v["status"] for k, v in report["stages"].items()}
    reference = Path(A.load_shims().REFERENCE_MODELS).is_dir()
    if code != 0 or report["pass"] is not True:
        raise AssertionError(f"acceptance --synthetic: exit {code}, {stages}")
    if stages["tokenizer_parity"] != ("pass" if reference else "skipped"):
        raise AssertionError(f"acceptance: tokenizer_parity "
                             f"{report['stages']['tokenizer_parity']}")
    emit("scripts", what="python3 -m seed_tpu_torch.scripts.acceptance "
         "--synthetic --device cuda --max-images 2 --max-new-tokens 8 "
         "--diffusion-steps 2", exit_code=code, stages=stages,
         tokenizer_parity=report["stages"]["tokenizer_parity"],
         seconds=seconds, card=name)


def scripts_geometry(name: str) -> None:
    """check_full_geometry for the 8B and 14B, LoRA and --full, at tp=2 x
    fsdp=4."""
    from seed_tpu_torch.scripts import check_full_geometry as CG
    for model in ("8b", "14b"):
        for full in (False, True):
            g = CG.main(["--model", model, "--tp", "2", "--devices=8"]
                        + (["--full"] if full else []))
            if g["undivided"]:
                raise AssertionError(f"geometry {model}: {g['undivided']}")
            emit("scripts", what="python3 -m seed_tpu_torch.scripts."
                 "check_full_geometry --tp 2 --devices=8", model=model,
                 lora=not full, mesh=g["mesh"],
                 gib_per_rank={k: v / 2 ** 30 for k, v in g["bytes"].items()},
                 total_gib_per_rank=g["total_bytes"] / 2 ** 30,
                 undivided=g["undivided"], card=name)


def gc_collect() -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def phase_scripts(name: str, scratch: Path) -> None:
    """The five command lines of seed_tpu_torch.scripts in process through
    their main(); of the kernels only short_mha (their bf16 encodes), the
    flash forward and the GroupNorm kernel (seed_tokenizer_inference's
    decode) are on their path."""
    before = _launch_counts()
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        jpeg = tmp / "image.jpg"
        write_jpeg(jpeg, SEED + 12)
        encodes = scripts_llama(name, jpeg)
        gc_collect()
        encodes += scripts_tokenizer(name, jpeg, tmp)
        gc_collect()
        scripts_merge(name, tmp)
        gc_collect()
        scripts_acceptance(name, tmp)
    scripts_geometry(name)
    launched = _launched_since(before)
    emit("launches", path="scripts", **launched, card=name)
    # the bf16 encodes run the ViT's attention through short_mha, one launch
    # a block; acceptance encodes in fp32 on mha; seed_tokenizer_inference's
    # one bf16 decode runs the UNet's self-attention through the flash
    # forward and its GroupNorms through the GroupNorm kernel: its resident
    # decoder runs the pass eagerly twice (the graph's warm-up and capture),
    # and the 20 replays launch from the graph, which no counter sees; the
    # VAE runs once. acceptance's TINY_UNCLIP decoder (fp32 weights, bf16
    # latents: every conv gives bf16) decodes one image twice: its GroupNorms
    # take the kernel in the pass's warm-up and capture and in both VAEs
    from seed_tpu_torch.models.seed_tokenizer import SEED_TOKENIZER
    from seed_tpu_torch.models.unclip import SD21_UNCLIP, TINY_UNCLIP
    want = dict.fromkeys(launched, 0)
    want["short_mha"] = SEED_TOKENIZER.vit.depth * encodes
    want["flash_fwd"] = 2 * UNET_FLASH_CALLS
    want["group_norm_kernel"] = sum(
        2 * unet_gn_calls(c.unet) + n_vae * vae_gn_calls(c.vae)
        for c, n_vae in ((SD21_UNCLIP, 1), (TINY_UNCLIP, 2)))
    if launched != want:
        raise AssertionError(f"the scripts launched {launched}, not {want} "
                             f"({encodes} bf16 encodes)")


def redesigned_smem_bytes() -> dict:
    """Dynamic shared memory of one block of the redesigned kernels at the
    main paths' shapes (head dims 88 and 128, the flash kernels in both
    types; short_mha's fp32 kernel at the tokenizer training's S = 257; the
    bf16 int8 matmul; the W8A8 encode's M = 2056; the GroupNorm statistics
    kernel at 960 channels), as their launchers ask."""
    from seed_tpu_torch.ops import flash_attention as TF
    from seed_tpu_torch.ops import group_norm as GN
    from seed_tpu_torch.ops import int8_matmul as TI
    from seed_tpu_torch.ops import kernels
    short = kernels.load("short_mha", TF._SIGNATURES)
    flash = TF._flash_lib(torch.bfloat16, 128)
    int8 = kernels.load("int8_matmul", TI._SIGNATURES)
    w8a8 = kernels.load("w8a8_matmul", TI._W8A8_SIGNATURES)
    gn = kernels.load("group_norm", GN._SIGNATURES)
    return {"short_mha": short.seed_short_mha_smem_bytes(257, 88, 1),
            "short_mha_f32": short.seed_short_mha_f32_plan(257, 257, 88, 1),
            **{k: flash.seed_flash_smem_bytes(i, 1, 128) for i, k in
               enumerate(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))},
            **{k + "_f32": flash.seed_flash_smem_bytes(i, 0, 128) for i, k in
               enumerate(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))},
            "int8_matmul": int8.seed_int8_matmul_smem_bytes(1),
            "w8a8_matmul": w8a8.seed_w8a8_smem_bytes(2056),
            "group_norm": gn.seed_group_norm_smem_bytes(GN_SHAPES[0][2])}


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from seed_tpu_torch.models import seed_tokenizer as ST
    from seed_tpu_torch.models.unclip import SD21_UNCLIP, UnCLIPDecoder
    from seed_tpu_torch.ops.flash_attention import short_mha
    from seed_tpu_torch.ops.int8_matmul import int8_matmul, w8a8_matmul

    name = card()
    usage = phase_build(name)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    record = phase_kernels(name, flush)
    record.update(phase_int8_kernel(name, flush, usage))
    record.update(phase_flash_kernels(name, flush))
    record.update(phase_w8a8_kernel(name, flush, usage))
    record.update(phase_group_norm_kernel(name, flush))
    del flush
    from seed_tpu_torch.ops import flash_attention as TF
    # the fp32 instances of rows 2-5, on no path: launches from here on
    int8_matmul.launches_f32 = 0
    for fn in (TF.flash_fwd, TF.flash_bwd_dq, TF.flash_bwd_dkv):
        fn.launches_f32 = 0

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params32 = ST.init_seed_tokenizer(gen, ST.SEED_TOKENIZER, torch.float32)
    raw = torch.randint(0, 256, (8, 256, 256, 3), dtype=torch.uint8,
                        generator=gen, device="cuda")
    phase_reference(name, params32, raw)
    tok_params = _cast(params32, torch.bfloat16)
    del params32

    def read_and_check(path: str, counters) -> dict:
        got = {fn.__name__: fn.launches for fn in counters}
        emit("launches", path=path, **got, card=name)
        for kernel, n in got.items():
            if n == 0:
                raise AssertionError(f"{kernel} was never launched on the "
                                     f"{path} path")
        return got

    # the serving path: every launch from here on is counted
    short_mha.launches = 0
    int8_matmul.launches = 0
    codes = phase_encode(name, tok_params, raw)
    llama_int8 = init_llama_int8(name)
    phase_serve(name, llama_int8, tok_params, codes)
    launches = read_and_check("serving", (short_mha, int8_matmul))

    # the throughput server's path, counted on its own
    server_kernels = (short_mha, int8_matmul, w8a8_matmul)
    for fn in server_kernels:
        fn.launches = 0
    qparams, qcfg = phase_w8a8_encode(name, tok_params, raw)
    engine = phase_scheduler(name, llama_int8)
    unclip32, unclip16 = init_unclip_full(name)
    decoder = UnCLIPDecoder(unclip16, SD21_UNCLIP, offload=True)
    try:
        phase_http(name, engine, qparams, qcfg, decoder)
    finally:
        engine.close()
    del engine, qparams
    torch.cuda.empty_cache()
    phase_caches_and_beam(name, llama_int8, tok_params, codes)
    for kernel, n in read_and_check("server", server_kernels).items():
        launches[kernel] = launches.get(kernel, 0) + n

    # the de-tokenizer: the flash forward in its bf16 UNet, no path's count;
    # the GroupNorm kernel's path (its bf16 UNet and VAE)
    from seed_tpu_torch.ops.group_norm import group_norm_kernel
    group_norm_kernel.launches = 0
    phase_unet_pass(name, unclip32, unclip16)
    phase_detokenize(name, llama_int8, tok_params, codes, unclip32, decoder)
    launches["group_norm"] = read_and_check(
        "detokenize", (group_norm_kernel,))["group_norm_kernel"]
    del unclip32, unclip16
    torch.cuda.empty_cache()

    # the eval path (11a, 11b), counted on its own
    short_mha.launches = 0
    int8_matmul.launches = 0
    phase_fid(name, tok_params, raw, codes, decoder)
    phase_vqa(name, llama_int8, tok_params, raw)
    for kernel, n in read_and_check("eval", (short_mha, int8_matmul)).items():
        launches[kernel] += n
    del decoder
    del tok_params, codes, raw, llama_int8
    torch.cuda.empty_cache()
    # the training path: phase_train zeroes its kernels' counters itself
    train_launches, synthetic_ms = phase_train(name)
    launches.update(train_launches)
    torch.cuda.empty_cache()
    # the two training entry points, each a path of its own (phases 9, 10)
    train_llm_launches, phase9 = phase_train_llm(name, synthetic_ms)
    for kernel, n in train_llm_launches.items():
        launches[kernel] += n
    from seed_tpu_torch.utils.metrics_logging import MetricLogger
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    short_mha.launches = 0
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        tok_launches, fp32_stage1, common = phase_train_tokenizer(
            name, flush, tmp)
        emit("launches", path="train_tokenizer", short_mha=tok_launches,
             card=name)
        if tok_launches == 0:
            raise AssertionError("short_mha was never launched on the "
                                 "train_tokenizer path")
        launches["short_mha"] += tok_launches
        del flush
        # 11c and 11d log through one MetricLogger (JSON lines under build/)
        logger = MetricLogger(log_file=str(scratch / "eval_log.jsonl"))
        phase_captions(name, tmp, common, logger)
    torch.cuda.empty_cache()
    phase_dvm(name, logger)
    torch.cuda.empty_cache()
    # the sharded programs on a one-rank NCCL group, a path of their own
    for kernel, n in phase_parallel(name, phase9).items():
        launches[kernel] += n
    phase_extract_image_ids(name)
    gc_collect()
    phase_scripts(name, scratch)
    for kernel, n in launches.items():
        if n == 0:
            raise AssertionError(f"{kernel} was never launched on its main path")

    flash_cu = "seed_tpu_torch/csrc/flash_attention.cu"
    sources = {"short_mha": ("seed_tpu_torch/csrc/short_mha.cu",
                             "seed_tpu/ops/flash_attention.py:170"),
               "int8_matmul": ("seed_tpu_torch/csrc/int8_matmul.cu",
                               "seed_tpu/ops/int8_matmul.py:32"),
               "flash_fwd": (flash_cu, "seed_tpu/ops/flash_attention.py:60"),
               "flash_bwd_dq": (flash_cu, "seed_tpu/ops/flash_attention.py:335"),
               "flash_bwd_dkv": (flash_cu, "seed_tpu/ops/flash_attention.py:378"),
               "w8a8_matmul": ("seed_tpu_torch/csrc/w8a8_matmul.cu",
                               "seed_tpu/ops/int8_matmul.py:93"),
               "group_norm": ("seed_tpu_torch/csrc/group_norm.cu", None)}
    kernels = [dict(name=k, route="cuda", source=source, replaces=replaces,
                    launches=launches[k],
                    max_abs_err=record[k]["max_abs_err"], ms=record[k]["ms"],
                    plain_ms=record[k]["plain_ms"],
                    bound_ms=record[k]["bound_ms"],
                    bound_by=record[k]["bound_by"],
                    library_ms=record[k]["library_ms"])
               for k, (source, replaces) in sources.items()]
    # nvcc's registers and spills of each redesigned kernel at the main
    # path's instance (short_mha: padded head dim 96, the exact epilogue, and
    # its fp32 kernel at 96; the
    # flash kernels: 128; row 2: the bf16 kernel; row 6: the 128 x 128 tile,
    # bf16 out), at every other instance, and its shared memory
    main_dp = {"short_mha": "96/0", "flash_fwd": "128", "flash_bwd_dq": "128",
               "flash_bwd_dkv": "128", "int8_matmul": "int8_mm_bf16",
               "w8a8_matmul": "2/2/4/4/bf16", "group_norm": "4/1"}
    smem = redesigned_smem_bytes()
    for entry in kernels:
        k = entry["name"]
        per_dp = usage.get(k, {})
        if k == "int8_matmul":
            entry["gemm_ms"] = record[k]["gemm_ms"]
        if k == "short_mha":      # the recompute design, the fp32 instance
            entry["shape"] = "B=256 S=257 H=16 D=88, bf16, exact"
            entry["b8"] = record[k]["b8"]
            rec = usage.get("short_mha_recompute", {})
            entry["recompute_kernel"] = dict(
                name="short_mha_bf16_kernel",
                registers=rec.get("96/0", {}).get("registers"),
                registers_by_instance={key: u.get("registers")
                                       for key, u in sorted(rec.items())},
                spill_bytes=(sum(spill_bytes(u) for u in rec.values())
                             if rec else None))
            f32 = usage.get("short_mha_f32", {})
            entry["fp32_train_tokenizer"] = fp32_stage1
            entry["fp32_kernel"] = dict(
                name="short_mha_f32_kernel",
                registers=f32.get("96", {}).get("registers"),
                registers_by_instance={key: u.get("registers")
                                       for key, u in sorted(f32.items())},
                spill_bytes=(sum(spill_bytes(u) for u in f32.values())
                             if f32 else None),
                smem_bytes=smem["short_mha_f32"])
        if k == "int8_matmul":    # int8_mm_f32: fp32 x, on no path
            entry["fp32_x"] = dict(record[k]["fp32_x"],
                                   launches=int8_matmul.launches_f32)
        if k == "flash_fwd":     # the UNet's shapes, bf16
            entry["unet"] = record[k]["unet"]
        if k == "group_norm":    # the port's own kernel: no TPU counterpart
            for key in ("shape", "ms_without_silu", "library", "bound_share",
                        "plan", "vae", "resident"):
                entry[key] = record[k][key]
            res = usage.get("group_norm_resident", {})
            entry["resident_kernel"] = dict(
                name="gn_resident_kernel",
                registers_by_instance={key: u.get("registers")
                                       for key, u in sorted(res.items())},
                spill_bytes=(sum(spill_bytes(u) for u in res.values())
                             if res else None))
        if k.startswith("flash_"):     # the fp32 kernels, on no path
            entry["fp32"] = dict(record[k]["fp32"],
                                 launches=getattr(TF, k).launches_f32)
            f32 = usage.get(k + "_f32", {})
            if k + "_f32" in smem:    # the split-TF32 instances
                entry["fp32"]["kernel"] = dict(
                    name=k + "_f32_kernel",
                    registers=f32.get("128", {}).get("registers"),
                    registers_by_instance={key: u.get("registers")
                                           for key, u in sorted(f32.items())},
                    spill_bytes=(sum(spill_bytes(u) for u in f32.values())
                                 if f32 else None),
                    smem_bytes=smem[k + "_f32"])
        entry.update(
            ms_host_included=record[k].get("ms_host_included"),
            registers=per_dp.get(main_dp[k], {}).get("registers"),
            registers_by_instance={key: u.get("registers")
                                   for key, u in sorted(per_dp.items())},
            spill_bytes=(sum(u.get("spill_stores", 0) + u.get("spill_loads", 0)
                             for u in per_dp.values()) if per_dp else None),
            smem_bytes=smem[k])
    print(name)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
