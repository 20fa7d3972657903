"""Interleaved generation: the three canonical tasks of the reference
(scripts/seed_llama_inference_8B.py:94-120), visual question answering,
text-to-image and multimodal-prompt image generation (counterpart of
scripts/seed_llama_inference.py, with its flags).

    python3 -m seed_tpu_torch.scripts.seed_llama_inference --model 8b \\
        --llm-ckpt ckpts/seed-llama-8b --tokenizer-ckpt ckpts/tokenizer \\
        --text-tokenizer ckpts/llama_tokenizer --image images/cat.jpg

The LLM runs in bf16, not quantized, through ``LlamaEngine``; the SEED
tokenizer at its default config (plain attention). Without checkpoints both
take seeded random weights (seeds 0 and 1). Sampling is on (``top_p`` 0.5,
temperature 1.0); the text-to-image and edit prompts force the image block's
first token (BOI). It runs on the card (``--device cuda``, the default) and
raises where there is none.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..models import llama as M
from ..models import seed_tokenizer as ST
from ..ops.preprocess import preprocess
from ..serving.engine import GenerationConfig, LlamaEngine
from ..serving.multimodal import (ByteTextTokenizer, HFTextTokenizer,
                                  SeedLlamaInterface)
from ..utils.checkpoint import restore_checkpoint

# the script's inline tiny config (scripts/seed_llama_inference.py:42-44)
TINY = M.LlamaConfig(vocab_size=40194, dim=256, layers=2, heads=4,
                     kv_heads=4, ffn_dim=512, max_seq_len=1024)
MODELS = {"8b": M.SEED_LLAMA_8B, "14b": M.SEED_LLAMA_14B, "tiny": TINY}

VQA = "What is this animal?"
T2I = "Can you generate an image of a dog on the green grass?"
EDIT = "Can you make the cat wear sunglasses?"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python3 -m seed_tpu_torch.scripts.seed_llama_inference",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=["8b", "14b", "tiny"], default="tiny")
    ap.add_argument("--llm-ckpt", default=None)
    ap.add_argument("--tokenizer-ckpt", default=None)
    ap.add_argument("--text-tokenizer", default=None,
                    help="HF LlamaTokenizer path (sentencepiece)")
    ap.add_argument("--image", default=None)
    ap.add_argument("--max-new-tokens", type=int, default=512)
    ap.add_argument("--top-p", type=float, default=0.5)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def read_image(path: str, device) -> torch.Tensor:
    """uint8 [1, H, W, 3] of the RGB image at ``path``."""
    from PIL import Image
    arr = np.asarray(Image.open(path).convert("RGB"), np.uint8)
    return torch.from_numpy(arr.copy())[None].to(device)


def build(args, tok_cfg: ST.SeedTokenizerConfig = ST.SEED_TOKENIZER,
          tok_params=None, llm_params=None):
    """(interface, sampling config, the image's 32 codes or None).
    ``tok_params`` / ``llm_params`` given by the caller take the place of
    the checkpoints and the seeded init."""
    device = resolve_device(args.device)
    cfg = MODELS[args.model]
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)
    if llm_params is None:
        llm_params = (restore_checkpoint(args.llm_ckpt, device=device)
                      if args.llm_ckpt else
                      M.init_llama(gen(0), cfg, torch.bfloat16, device))
    if tok_params is None:
        tok_params = (restore_checkpoint(args.tokenizer_ckpt, device=device)
                      if args.tokenizer_ckpt else
                      ST.init_seed_tokenizer(gen(1), tok_cfg, torch.bfloat16,
                                             device))
    text_tok = (HFTextTokenizer(args.text_tokenizer) if args.text_tokenizer
                else ByteTextTokenizer())
    engine = LlamaEngine(llm_params, cfg, device=device)
    iface = SeedLlamaInterface(engine, tok_params, tok_cfg, text_tok,
                               device=device)
    sampling = GenerationConfig(max_new_tokens=args.max_new_tokens,
                                top_p=args.top_p, temperature=args.temperature,
                                do_sample=True,
                                eos_token_id=text_tok.eos_token_id)
    codes = None
    if args.image:
        raw = read_image(args.image, device)
        codes = iface.encode_image(preprocess(raw, tok_cfg.vit.image_size,
                                              torch.bfloat16))[0]
        print("image codes:", codes.tolist())
    return iface, sampling, codes


def show(segments) -> None:
    for s in segments:
        if s.kind == "text":
            print("TEXT:", s.text)
        else:
            print("IMAGE codes:", s.image_codes[0][:8].tolist(), "...",
                  "embedding" if s.image_embedding is not None else "")


def run_prompts(iface: SeedLlamaInterface, gen: GenerationConfig,
                image_codes: Optional[np.ndarray]) -> List[Dict]:
    """The three prompts (the two with the image only when there is one),
    in the script's order; per prompt its task, whether the image block was
    forced, the generated ids, the segments and the seconds it took."""
    tasks = []
    if image_codes is not None:
        tasks.append(("visual question answering", [image_codes, VQA], False))
    tasks.append(("text-to-image generation", [T2I], True))
    if image_codes is not None:
        tasks.append(("multimodal prompt image generation",
                      [image_codes, EDIT], True))
    results = []
    for task, parts, force in tasks:
        print(f"== {task} ==")
        t0 = time.perf_counter()
        ids = iface.generate_ids(parts, gen, force_image=force)
        seconds = time.perf_counter() - t0
        segments = iface.split_output(ids)
        show(segments)
        results.append(dict(task=task, forced=force, ids=ids,
                            segments=segments, seconds=seconds))
    return results


def main(argv=None) -> List[Dict]:
    args = parse_args(argv)
    iface, gen, codes = build(args)
    return run_prompts(iface, gen, codes)


if __name__ == "__main__":
    main()
