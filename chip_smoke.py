"""Drive the PyTorch port (seed_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one line of its own:

1. build   — compile the CUDA kernels from seed_tpu_torch/csrc/ (one nvcc per
             source, all at once) into build/seed_tpu_torch/.
2. kernels — hold each kernel against its plain PyTorch version on the card at
             the main path's shapes, and time kernel, plain version, the
             library yardstick and the bound.
3. reference — the full-width fp32 encode through the short_mha kernel
             against the same encode through the plain mha path.
4. encode  — full SEED tokenizer (EVA-ViT-g, 39 blocks), seeded bf16 weights:
             8 uint8 images -> preprocess -> 32 ids each, exact and fast.
5. serve   — SEED-LLaMA-8B, seeded bf16 weights quantized to int8 layer by
             layer: batched LlamaEngine.generate and SeedLlamaInterface
             requests, greedy and sampled.

Phases 4 and 5 are the main path: the launch counters are set to 0 just
before phase 4 and read just after phase 5. Every failure raises, so the
script exits non-zero and prints no result line. The last line is the device
record; the line before it lists the kernels, the one before that the card.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12             # dense bf16 tensor-core peak
FP32_FLOPS = 67e12              # fp32 outside the tensor cores
PEAK_FLOPS = {torch.bfloat16: BF16_FLOPS, torch.float32: FP32_FLOPS}
SEED = 0


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, iters: int = 10, flush: torch.Tensor = None) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events), after
    one warm-up call; ``flush`` is overwritten before each call so the inputs
    come from device memory, not from the 50 MB L2, as they do on the path."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
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


# --------------------------------------------------------------- phase 1

def phase_build(name: str) -> None:
    from seed_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    reports = kernels.build()
    seconds = time.perf_counter() - t0
    for kernel, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  nvcc {kernel}: {line.strip()}")
    emit("build", seconds=seconds, built=sorted(reports), card=name)


# --------------------------------------------------------------- phase 2

def _qkv_views(gen, B, S, H, D, dtype):
    """q/k/v as strided views of one fused [B, S, 3*H*D] tensor, as the ViT
    block hands them to the kernel."""
    qkv = torch.randn(B, S, 3 * H * D, generator=gen, device="cuda").to(dtype)
    return tuple(t.reshape(B, S, H, D) for t in qkv.split(H * D, dim=-1))


def phase_kernels(name: str, flush: torch.Tensor) -> dict:
    """Each kernel against its plain version. Returns the per-kernel record
    (errors and times at the main path's shape) for the final kernels line."""
    import torch.nn.functional as F
    from seed_tpu_torch.ops.flash_attention import short_mha, short_mha_plain
    from seed_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain
    from seed_tpu_torch.ops.quantization import quantize_weight

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    record = {}

    # short_mha: EVA-ViT-g shape, both io types, all three epilogues
    # (D=88 -> exact and fast-with-ones; D=128 -> fast-divide).
    # Tolerance: fp32 2e-5 (sum order only); bf16 2**-6 (a bf16 rounding of
    # p or of the output may land one ulp apart when sums differ in order).
    tol = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -6}
    worst = 0.0
    for D, exact in ((88, True), (88, False), (128, True), (128, False)):
        for dtype in (torch.bfloat16, torch.float32):
            B, S, H = 8, 257, 16
            q, k, v = _qkv_views(gen, B, S, H, D, dtype)
            scale = D ** -0.5
            got = short_mha(q, k, v, scale, exact)
            want = short_mha_plain(q, k, v, scale, exact)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            same = (got == want).float().mean().item()
            if not err <= tol[dtype]:
                raise AssertionError(f"short_mha D={D} exact={exact} {dtype}: "
                                     f"max_abs_err {err} > {tol[dtype]}")
            worst = max(worst, err)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            ms = time_ms(lambda: short_mha(q, k, v, scale, exact), flush=flush)
            plain = time_ms(lambda: short_mha_plain(q, k, v, scale, exact),
                            flush=flush)
            lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                          flush=flush)
            nbytes = 4 * B * S * H * D * dtype.itemsize
            flops = 4 * B * H * S * S * D
            bms, by = bound_ms(nbytes, flops, PEAK_FLOPS[dtype])
            timing = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                          bound_by=by)
            if dtype == torch.bfloat16 and D == 88 and exact:
                record["short_mha"] = dict(timing)      # the exact encode's call
            emit("kernels", kernel="short_mha", B=B, S=S, H=H, D=D,
                 exact=exact, dtype=str(dtype).split(".")[-1],
                 max_abs_err=err, frac_equal=same, tol=tol[dtype], card=name,
                 **timing)
    record["short_mha"]["max_abs_err"] = worst

    # int8_matmul: the four (K, N) pairs of the 8B prefill at M = 4 x 64,
    # bf16 x; plus fp32 x and a ragged M once each.
    # Tolerance, relative to max|y|: bf16 2**-7 (one output rounding apart),
    # fp32 1e-5 (sum order only).
    per_prefill = {(4096, 4096): 4 * 32, (4096, 11008): 2 * 32,
                   (11008, 4096): 32, (4096, 40320): 1}
    worst = 0.0
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0)
    ops_total = bytes_total = 0.0
    cases = [(256, K, N, torch.bfloat16) for (K, N) in per_prefill]
    cases += [(256, 4096, 4096, torch.float32), (300, 4096, 11008, torch.bfloat16)]
    for M, K, N, dtype in cases:
        w = torch.randn(K, N, generator=gen, device="cuda") * 0.02
        qw = quantize_weight(w)
        del w
        x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
        got = int8_matmul(x, qw["kernel_q"], qw["scale"])
        want = int8_matmul_plain(x, qw["kernel_q"], qw["scale"])
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        limit = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
        if not rel <= limit:
            raise AssertionError(f"int8_matmul M={M} K={K} N={N} {dtype}: "
                                 f"relative error {rel} > {limit}")
        worst = max(worst, err)
        wq, sc = qw["kernel_q"], qw["scale"]
        ms = time_ms(lambda: int8_matmul(x, wq, sc), flush=flush)
        plain = time_ms(lambda: int8_matmul_plain(x, wq, sc), flush=flush)
        lib = time_ms(lambda: x @ wq.to(x.dtype) * sc, flush=flush)
        nbytes = M * K * dtype.itemsize + K * N + N * 4 + M * N * dtype.itemsize
        flops = 2 * M * N * K
        bms, by = bound_ms(nbytes, flops, PEAK_FLOPS[dtype])
        n = per_prefill.get((K, N), 0) if (M, dtype) == (256, torch.bfloat16) else 0
        tot["ms"] += n * ms
        tot["plain_ms"] += n * plain
        tot["library_ms"] += n * lib
        bytes_total += n * nbytes
        ops_total += n * flops
        emit("kernels", kernel="int8_matmul", M=M, K=K, N=N,
             dtype=str(dtype).split(".")[-1], max_abs_err=err, rel_err=rel,
             tol_rel=limit, launches_per_prefill=n, card=name, ms=ms,
             plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by)
        del qw, x, got, want
    # the record is per launch, averaged over one prefill's mix of shapes
    n = sum(per_prefill.values())
    bms, by = bound_ms(bytes_total / n, ops_total / n, BF16_FLOPS)
    record["int8_matmul"] = dict(ms=tot["ms"] / n, plain_ms=tot["plain_ms"] / n,
                                 library_ms=tot["library_ms"] / n, bound_ms=bms,
                                 bound_by=by, max_abs_err=worst)
    emit("kernels", kernel="int8_matmul", summary="mean per launch over one "
         "8B prefill (225 launches)", card=name, **record["int8_matmul"])
    return record


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
        for label, cfg in (("exact", _flash_cfg(ST.SEED_TOKENIZER, True)),
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
    agree = (ids["exact"] == ids["fast"]).float().mean().item()
    emit("encode", fast_vs_exact_id_agreement=agree, card=name)
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


def phase_serve(name: str, tok_params, codes: torch.Tensor) -> None:
    """SEED-LLaMA-8B, int8 weights, served through LlamaEngine and
    SeedLlamaInterface."""
    from seed_tpu_torch.models import llama as M
    from seed_tpu_torch.models import seed_tokenizer as ST
    from seed_tpu_torch.ops.int8_matmul import can_use_kernel, int8_matmul
    from seed_tpu_torch.ops.quantization import DEFAULT_TARGETS
    from seed_tpu_torch.serving.engine import GenerationConfig, LlamaEngine
    from seed_tpu_torch.serving.multimodal import (ByteTextTokenizer,
                                                   SeedLlamaInterface)
    cfg = M.SEED_LLAMA_8B
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    t0 = time.perf_counter()
    params = M.init_llama(gen, cfg, torch.bfloat16,
                          quantize_targets=DEFAULT_TARGETS)
    torch.cuda.synchronize()
    emit("serve", what="init SEED_LLAMA_8B, int8 layer by layer",
         seconds=time.perf_counter() - t0,
         gib_allocated=torch.cuda.memory_allocated() / 2 ** 30, card=name)
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


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from seed_tpu_torch.models import seed_tokenizer as ST
    from seed_tpu_torch.ops.flash_attention import short_mha
    from seed_tpu_torch.ops.int8_matmul import int8_matmul

    name = card()
    phase_build(name)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    record = phase_kernels(name, flush)
    del flush

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params32 = ST.init_seed_tokenizer(gen, ST.SEED_TOKENIZER, torch.float32)
    raw = torch.randint(0, 256, (8, 256, 256, 3), dtype=torch.uint8,
                        generator=gen, device="cuda")
    phase_reference(name, params32, raw)
    tok_params = _cast(params32, torch.bfloat16)
    del params32

    # the main path: every launch from here on is counted
    short_mha.launches = 0
    int8_matmul.launches = 0
    codes = phase_encode(name, tok_params, raw)
    phase_serve(name, tok_params, codes)
    launches = {"short_mha": short_mha.launches,
                "int8_matmul": int8_matmul.launches}
    for kernel, n in launches.items():
        if n == 0:
            raise AssertionError(f"{kernel} was never launched on the main path")

    replaces = {"short_mha": "seed_tpu/ops/flash_attention.py:170",
                "int8_matmul": "seed_tpu/ops/int8_matmul.py:32"}
    kernels = [dict(name=k, route="cuda", source=f"seed_tpu_torch/csrc/{k}.cu",
                    replaces=replaces[k], launches=launches[k],
                    max_abs_err=record[k]["max_abs_err"], ms=record[k]["ms"],
                    plain_ms=record[k]["plain_ms"],
                    bound_ms=record[k]["bound_ms"],
                    bound_by=record[k]["bound_by"],
                    library_ms=record[k]["library_ms"])
               for k in ("short_mha", "int8_matmul")]
    print(name)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
