"""Where the time goes on the port's main path, on one NVIDIA GPU.

    python3 profile_port.py

Seeded random weights at full width, as in chip_smoke.py. Four regions:
one SEED-tokenizer encode (exact config, B=8), one SEED-LLaMA-8B int8
prefill (B=4 x 64 tokens, M=256), 8 decode steps (B=4), and one optimizer
step of SEED-LLaMA-8B + LoRA training (bf16, grad_accum 2 x micro-batch 4 x
1024 tokens, per-layer recompute, flash kernels). For each region
it prints one JSON line with the host wall time (median of 5 runs, no
profiler), the device busy time (sum of kernel times under torch.profiler),
the device's idle share, and the kernels with the most device time.
"""
from __future__ import annotations

import json
import statistics
import sys
import time

import torch

import chip_smoke


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    raise AttributeError("profiler event without a device time")


def region(label: str, fn, card: str, reps: int = 5, top_n: int = 8) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device-side events only (kernels, copies, memsets); the CPU-side aten
    # ops that launched them carry the same time again
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    wall_ms = statistics.median(walls)
    if busy_ms <= 0:
        raise AssertionError(f"{label}: the profiler saw no device time")
    top = sorted(kernels, key=_device_us, reverse=True)[:top_n]
    print(json.dumps({
        "region": label, "wall_ms_median": wall_ms, "wall_ms_runs": walls,
        "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
        "launches": sum(e.count for e in kernels),
        "top_kernels": [{"name": e.key[:90], "count": e.count,
                         "device_ms": _device_us(e) / 1e3} for e in top],
        "card": card}), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        print("profile_port: needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from seed_tpu_torch.models import llama as M
    from seed_tpu_torch.models import seed_tokenizer as ST
    from seed_tpu_torch.ops import kernels
    from seed_tpu_torch.ops.preprocess import preprocess
    from seed_tpu_torch.ops.quantization import DEFAULT_TARGETS

    card = chip_smoke.card()
    kernels.build()
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    with torch.inference_mode():
        tok = ST.init_seed_tokenizer(gen, ST.SEED_TOKENIZER, torch.bfloat16)
        raw = torch.randint(0, 256, (8, 256, 256, 3), dtype=torch.uint8,
                            generator=gen, device="cuda")
        images = preprocess(raw, 224, torch.bfloat16)
        cfg = chip_smoke._flash_cfg(ST.SEED_TOKENIZER, True)
        region("encode exact B=8", lambda: ST.encode(tok, images, cfg), card)
        del tok

        lcfg = M.SEED_LLAMA_8B
        params = M.init_llama(gen, lcfg, torch.bfloat16,
                              quantize_targets=DEFAULT_TARGETS)
        ids = torch.randint(3, 32000, (4, 64), generator=gen, device="cuda")
        region("prefill B=4x64", lambda: M.prefill(
            params, ids, M.init_cache(lcfg, 4, 512), lcfg), card)
        cache = M.init_cache(lcfg, 4, 512)
        logits, cache = M.prefill(params, ids, cache, lcfg)
        tok_ids = logits[:, -1].argmax(-1)[:, None]

        def decode8():
            cache.index = 64          # rewrite the same 8 slots each run
            cache.valid[:, 64:] = False
            t = tok_ids
            for _ in range(8):
                out, _ = M.decode_step(params, t, cache, lcfg)
                t = out[:, 0].argmax(-1)[:, None]

        region("decode 8 steps B=4", decode8, card)
        del params, cache, logits

    # one optimizer step of LoRA training; the first call (lr(0) = 0, and the
    # first use of every shape) is region()'s warm-up
    from seed_tpu_torch.train import init_lora
    torch.cuda.empty_cache()
    base = M.init_llama(gen, lcfg, torch.bfloat16)
    trainer = chip_smoke.llm_trainer(base, lcfg, init_lora(gen, base, r=16, alpha=32))
    batch = next(chip_smoke._train_batches(1, lcfg.vocab_size, chip_smoke.SEED))
    region("train step 8B LoRA, 2 x 4 x 1024 tokens",
           lambda: trainer.train(iter([batch]), 1), card, reps=3, top_n=16)


if __name__ == "__main__":
    main()
