"""Where the time goes on the port's main path, on one NVIDIA GPU.

    python3 profile_port.py

Seeded random weights at full width, as in chip_smoke.py. Twelve regions:
one SEED-tokenizer encode (exact config, B=8), the same encode through the
W8A8 encoder (quantize_for_serving + serving_fast_config, as chip_smoke.py's
server phase runs it), the de-tokenizer's unit of work (one SD2.1 UNet pass
at B=1, a CFG batch of 2 at 96x96x4, and one VAE decode to 768x768, bf16;
a decode is 20 such passes and one VAE decode), one SEED-LLaMA-8B int8
prefill (B=4 x 64 tokens, M=256), 8 decode steps (B=4), 8 decode chunks of
the continuous-batching scheduler (16 fp8 slots, max_len 1024, 8 steps per
chunk), and one optimizer step of SEED-LLaMA-8B + LoRA training (bf16,
grad_accum 2 x micro-batch 4 x 1024 tokens, per-layer recompute, flash
kernels), and one step of each training entry point fed from tar shards
(train_llm at those shapes; train_tokenizer stage 1 at full width, batch
16), and the eval path's own work: Inception-v3 pool3 over 8 images (256 ->
299) in fp32 and in bf16, and one Trainer step of the discrete vision model
on the frozen CLIP-ViT-H tower (batch 16 at 224). For each region it prints one JSON line with the host wall time
(median of 5 runs, 3 for the heavier regions, no profiler), the device
busy time (sum of kernel times under torch.profiler),
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
    # ops that launched them carry the same time again, and so do the
    # device-side ranges of the program's spans (user annotations)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0
               and not e.is_user_annotation]
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
        qtok, qcfg = ST.quantize_for_serving(tok, ST.SEED_TOKENIZER)
        qcfg = ST.serving_fast_config(qcfg)
        region("encode W8A8 B=8", lambda: ST.encode(qtok, images, qcfg), card)
        del tok, qtok

        from seed_tpu_torch.models.unclip import (SD21_UNCLIP, decode_to_images,
                                                  init_unclip, unet_apply)
        ucfg = SD21_UNCLIP
        unclip = init_unclip(gen, ucfg, torch.bfloat16)
        n = ucfg.latent_size
        lat = torch.randn((2, n, n, 4), generator=gen, device="cuda").bfloat16()
        ctx = torch.randn((2, ucfg.text_ctx_len, ucfg.text_ctx_dim),
                          generator=gen, device="cuda").bfloat16()
        labels = torch.randn((2, 2 * ucfg.image_embed_dim), generator=gen,
                             device="cuda").bfloat16()
        t = torch.full((2,), 951, dtype=torch.int32, device="cuda")

        def detokenize():
            unet_apply(unclip["unet"], lat, t, ctx, labels, ucfg.unet)
            decode_to_images(unclip, lat[:1], ucfg)

        region("detokenize: one UNet pass (CFG batch 2 at 96x96x4) + one VAE "
               "decode to 768x768, bf16", detokenize, card, reps=3, top_n=12)
        del unclip

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
        del cache, logits

        # the scheduler's steady state: every slot busy, nothing queued, so a
        # step is one chunk of 8 decode + sample steps and one token transfer
        from seed_tpu_torch.serving.engine import GenerationConfig
        from seed_tpu_torch.serving.scheduler import ContinuousBatcher
        cb = ContinuousBatcher(params, lcfg, slots=16, max_len=1024,
                               cache_dtype=torch.float8_e4m3fn, decode_chunk=8)
        budget = GenerationConfig(max_new_tokens=900, temperature=0.7,
                                  top_p=0.5, eos_token_id=-1)
        for i in range(16):
            cb.submit(torch.randint(3, 32000, (60 + 2 * i,), generator=gen,
                                    device="cuda").tolist(), budget)

        def chunks8():
            for _ in range(8):
                cb.step()
            if any(r is None for r in cb.active):
                raise AssertionError("scheduler region: a slot ran empty")

        region("scheduler, 8 decode chunks of 8 steps, 16 fp8 slots", chunks8,
               card, reps=3)
        del params, cb

    # one optimizer step of LoRA training; the first call (lr(0) = 0, and the
    # first use of every shape) is region()'s warm-up
    from seed_tpu_torch.train import init_lora
    torch.cuda.empty_cache()
    base = M.init_llama(gen, lcfg, torch.bfloat16)
    trainer = chip_smoke.llm_trainer(base, lcfg, init_lora(gen, base, r=16, alpha=32))
    batch = next(chip_smoke._train_batches(1, lcfg.vocab_size, chip_smoke.SEED))
    region("train step 8B LoRA, 2 x 4 x 1024 tokens",
           lambda: trainer.train(iter([batch]), 1), card, reps=3, top_n=16)
    del base, trainer
    torch.cuda.empty_cache()
    entry_points(card)
    torch.cuda.empty_cache()
    eval_regions(card)


def eval_regions(card: str) -> None:
    """Inception pool3 at B=8 in fp32 (TF32 off) and bf16, as chip_smoke.py
    phase 11a runs it on the real images, and one discrete vision model step
    as 11d runs it."""
    from seed_tpu_torch.eval import inception_pool3, init_inception
    from seed_tpu_torch.models.layers import cast_tree
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 12)
    inc = init_inception(gen, with_fc=True)
    inc16 = cast_tree(inc, torch.bfloat16)
    imgs = torch.rand((8, 256, 256, 3), generator=gen, device="cuda")
    region("eval: Inception-v3 pool3 B=8 (256 -> 299), fp32",
           lambda: inception_pool3(inc, imgs), card)
    region("eval: Inception-v3 pool3 B=8 (256 -> 299), bf16",
           lambda: inception_pool3(inc16, imgs, dtype=torch.bfloat16), card)
    del inc, inc16
    _, trainer = chip_smoke.dvm_trainer(gen)
    batch = {"images": torch.randn((16, 224, 224, 3), generator=gen,
                                   device="cuda").to(torch.bfloat16)}
    region("eval: discrete vision model step, CLIP-ViT-H tower, batch 16",
           lambda: trainer.step(batch), card, reps=3, top_n=12)


def entry_points(card: str) -> None:
    """One step of each training entry point, fed by its own data thread
    from tar shards (chip_smoke.py phases 9 and 10 at the same flags): the
    wall holds the step and whatever wait for the next batch remains."""
    import tempfile
    from pathlib import Path

    from seed_tpu_torch.data import Prefetcher, batched, shuffle_buffer
    from seed_tpu_torch.serving.multimodal import ByteTextTokenizer
    from seed_tpu_torch.train import train_llm
    from seed_tpu_torch.train import train_tokenizer as TT
    from seed_tpu_torch.train.entry import Feed

    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        args = train_llm.parse_args(
            ["--data", chip_smoke.write_llm_shards(tmp), *chip_smoke.LLM_ARGS,
             "--steps", "100", "--output", str(tmp / "llm")])
        setup = train_llm.build(args)
        data = Prefetcher(train_llm.batch_stream(args, setup.tok), depth=2)
        feed = Feed(data, setup.trainer.device)
        region("train_llm step from tar shards, 8B LoRA, 2 x 4 x 1024 tokens",
               lambda: setup.trainer.train(feed, 1), card, reps=3, top_n=16)
        data.close()
        del setup, data, feed
        torch.cuda.empty_cache()

        args = TT.parse_args(["--data", chip_smoke.write_image_tar(tmp),
                              *chip_smoke.TOK_ARGS, "--stage", "1",
                              "--steps", "100", "--output", str(tmp / "tok")])
        setup = TT.build(args)
        collate = TT.make_collate(args, setup, ByteTextTokenizer())
        data = Prefetcher(batched(shuffle_buffer(TT.example_stream(args), 2000,
                                                 args.seed),
                                  args.batch_size, collate), depth=2)
        feed = Feed(data, setup.trainer.device)
        region("train_tokenizer stage 1 step, full width, batch 16 at 224",
               lambda: setup.trainer.train(feed, 1), card, reps=3, top_n=16)
        data.close()


if __name__ == "__main__":
    main()
