"""SEED-LLaMA training entry point, pretrain or SFT (counterpart of
scripts/train_llm.py, with its flags).

LoRA (or full) fine-tuning of LLaMA with the extended image-token vocabulary
on pre-tokenized pkl tar shards: the example stream -> shuffle buffer (4096)
-> micro-batches stacked [grad_accum, micro, ...] -> a background thread two
batches ahead; AdamW (b2 0.95, eps 1e-5, clip 1.0) on a cosine schedule with
a floor; per-layer recompute; causal attention through the flash kernels
(``--flash``); the full train state under ``<output>/state`` for
``--resume`` (streams are resampled on resume, as the reference's launch
scripts do) and a caption eval at every save point when an eval set is
given.

    python3 -m seed_tpu_torch.train.train_llm --data 'shards/*.tar' \\
        --mode pretrain --model 8b --steps 30000 --batch-size 128 \\
        --grad-accum 4 --lr 1.5e-4 --output ckpts/llm

It runs on the card (``--device cuda``, the default) and raises where there
is none; ``--device cpu`` runs it on the CPU. Under torchrun (or in a
process whose caller has initialised a process group) it trains through the
mesh Trainer over seed_tpu's ``auto_mesh(tp=--tp)`` with ``LLAMA_TP_RULES``,
the frozen base sharded by the same rules; each (data, fsdp) slice reads its
own share of the shard files and ``--batch-size`` stays global; rank 0 logs
and writes:

    torchrun --nproc_per_node 8 -m seed_tpu_torch.train.train_llm \\
        --data 'shards/*.tar' --model 8b --tp 2 --output ckpts/llm

Where it departs from the script: under ``--lora`` the script hands
``{"base", "lora"}`` to the trainer, so the base trains too (an 8B base
with its AdamW moments does not fit one 80 GB card). Here the trainer holds
``{"lora": adapters}`` and the loss closes over the frozen base; the saved
trees hold the adapters only, the base stays ``--llm-ckpt`` (or the seeded
init). ``--no-lora`` trains the whole tree, as the script does. The best
checkpoint follows CIDEr (the script looks the score up under a key that
the metrics never carry, so its first eval is always the best).
"""
from __future__ import annotations

import argparse
import json
import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..data import (Prefetcher, batched, build_caption_example,
                    build_conversation_example, collate, shuffle_buffer,
                    tar_source)
from ..data.pipeline import process_index_count
from ..parallel.partition import LLAMA_TP_RULES, shard_params
from ..models import llama as M
from ..serving.engine import GenerationConfig, LlamaEngine
from ..serving.multimodal import ByteTextTokenizer
from ..utils.checkpoint import restore_checkpoint
from .entry import (Feed, StepLog, generator, rank_device, train_mesh,
                    train_rounds)
from .lora import apply_lora, init_lora, merge_lora_weights
from .losses import cross_entropy
from .optim import adamw, cosine_with_floor, learnable_image_embeddings_only
from .trainer import Trainer, TrainerConfig

MODELS = {"8b": M.SEED_LLAMA_8B, "14b": M.SEED_LLAMA_14B,
          "small": M.SMALL_LLAMA, "tiny": M.TINY_LLAMA}
EVAL_KEY = "CIDEr"        # the reference's model-selection metric


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", required=True)
    ap.add_argument("--mode", choices=["pretrain", "sft"], default="pretrain")
    ap.add_argument("--model", choices=sorted(MODELS), default="tiny")
    ap.add_argument("--llm-ckpt", default=None)
    ap.add_argument("--steps", type=int, default=30000)
    ap.add_argument("--batch-size", type=int, default=8, help="global batch")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--max-length", type=int, default=1024)
    ap.add_argument("--lr", type=float, default=1.5e-4)
    ap.add_argument("--min-lr-ratio", type=float, default=0.05)
    ap.add_argument("--warmup", type=int, default=500)
    ap.add_argument("--weight-decay", type=float, default=0.05)
    ap.add_argument("--lora", action="store_true", default=True)
    ap.add_argument("--no-lora", dest="lora", action="store_false")
    ap.add_argument("--learnable-embeddings-only", action="store_true",
                    help="restrict embed_tokens / lm_head updates to the new "
                         "image-token rows (with --no-lora: under --lora "
                         "neither trains)")
    ap.add_argument("--old-vocab-size", type=int, default=32000,
                    help="first new-vocab row for --learnable-embeddings-only")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor parallel degree; one card runs 1")
    ap.add_argument("--flash", action="store_true", default=True,
                    help="causal attention through the flash kernels")
    ap.add_argument("--no-flash", dest="flash", action="store_false")
    ap.add_argument("--output", default="ckpts/llm")
    ap.add_argument("--save-steps", type=int, default=1000)
    ap.add_argument("--log-steps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest full train state (params, AdamW "
                         "moments, step) from <output>/state and continue; "
                         "data streams are resampled")
    ap.add_argument("--eval-data", default=None,
                    help="json(l) of {'input_ids': [...], 'image_id': i} "
                         "pretokenized eval prompts")
    ap.add_argument("--eval-annotations", default=None,
                    help="json {image_id: [reference captions]}")
    ap.add_argument("--eval-batches", type=int, default=50)
    ap.add_argument("--eval-batch-size", type=int, default=8)
    ap.add_argument("--eval-max-new-tokens", type=int, default=32)
    ap.add_argument("--eval-num-beams", type=int, default=1,
                    help="beam width for eval generation (the reference "
                         "evaluates with num_beams=5)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def llm_loss(cfg: M.LlamaConfig, base, use_flash: bool) -> Callable:
    """The training loss over the trainer's tree: ``{"lora": adapters}``
    merged into the frozen ``base``, or the whole model when ``base`` is
    None; per-layer recompute; next-token cross entropy."""
    def loss_fn(p, batch, rng):
        params = p if base is None else apply_lora(base, p["lora"])
        logits = M.forward(params, batch["input_ids"], cfg,
                           attn_mask=batch["attention_mask"], remat=True,
                           use_flash=use_flash)
        return cross_entropy(logits[:, :-1], batch["labels"][:, 1:])
    return loss_fn


@dataclass
class Setup:
    cfg: M.LlamaConfig
    base: Optional[Any]            # the frozen base under --lora, else None
    trainer: Trainer
    tok: ByteTextTokenizer

    def model(self):
        """The weights the model runs with: adapters merged into the base
        (full tensors under a mesh)."""
        from ..parallel.local import full_tree
        p = self.trainer.state.params
        return full_tree(p if self.base is None else merge_lora_weights(
            self.base, p["lora"]))


def build(args) -> Setup:
    """Model, adapters, optimizer and trainer on ``args.device`` (this
    rank's card under a mesh)."""
    if args.lora and args.learnable_embeddings_only:
        raise ValueError("--learnable-embeddings-only restricts embed_tokens "
                         "and lm_head, which train only under --no-lora")
    device = rank_device(resolve_device(args.device))
    mesh = train_mesh(device, args.tp)
    cfg = MODELS[args.model]
    base = (restore_checkpoint(args.llm_ckpt, device=device) if args.llm_ckpt
            else M.init_llama(generator(device, args.seed), cfg,
                              torch.bfloat16, device))
    if args.lora:
        params = {"lora": init_lora(generator(device, args.seed + 1), base,
                                    r=16, alpha=32)}
        if mesh is not None:
            base = shard_params(base, mesh, LLAMA_TP_RULES)
    else:
        params, base = base, None
    sched = cosine_with_floor(args.lr, args.warmup, args.steps,
                              args.min_lr_ratio)
    opt = adamw(sched, b1=0.9, b2=0.95, eps=1e-5,
                weight_decay=args.weight_decay, clip_norm=1.0, params=params)
    if args.learnable_embeddings_only:
        opt = learnable_image_embeddings_only(opt, args.old_vocab_size,
                                              vocab_size=cfg.vocab_size)
    trainer = Trainer(llm_loss(cfg, base, args.flash), params, opt,
                      TrainerConfig(grad_accum=args.grad_accum,
                                    log_every=args.log_steps), device=device,
                      mesh=mesh, rules=LLAMA_TP_RULES)
    return Setup(cfg, base, trainer, ByteTextTokenizer())


def example_stream(args, tok):
    """Training examples from the shards, forever (resampled per epoch)."""
    rng = random.Random(args.seed)
    for rec in tar_source(args.data, cycle_count=None, seed=args.seed):
        if args.mode == "pretrain":
            ex = build_caption_example(rec, tok, args.max_length,
                                       reverse_ratio=0.5, rng=rng)
        else:
            turns = rec.get("turns") or [
                {"question": rec.get("question", rec.get("text", "")),
                 "answer": rec.get("answer", ""),
                 "image_ids": rec.get("image_ids")}]
            ex = build_conversation_example(turns, tok, args.max_length)
        if ex is not None:
            yield ex


def batch_stream(args, tok):
    """Micro-batches of the shuffled examples; with grad_accum > 1, each
    step's micro-batches stacked to [grad_accum, micro, ...]. Under a mesh
    the micro-batches are this (data, fsdp) slice's share of the global
    batch, from its own share of the files."""
    micro = args.batch_size // args.grad_accum // process_index_count()[1]
    base_iter = batched(shuffle_buffer(example_stream(args, tok), 4096,
                                       args.seed), micro, collate)
    while True:
        if args.grad_accum == 1:
            yield next(base_iter)
        else:
            micros = [next(base_iter) for _ in range(args.grad_accum)]
            yield {k: np.stack([m[k] for m in micros]) for k in micros[0]}


def eval_prompts(args):
    """The eval prompts in batches of ``--eval-batch-size``."""
    from ..eval import iter_json_records
    ids, imgs = [], []
    for rec in iter_json_records(args.eval_data):
        ids.append([int(t) for t in rec["input_ids"]])
        imgs.append(rec["image_id"])
        if len(ids) == args.eval_batch_size:
            yield {"input_ids": ids, "image_id": imgs}
            ids, imgs = [], []
    if ids:
        yield {"input_ids": ids, "image_id": imgs}


def run_eval(args, setup: Setup) -> Optional[Dict[str, float]]:
    """Greedy (or beam) generation on the held-out prompts and the caption
    metrics, on the merged weights; None when no eval set is given."""
    if not (args.eval_data and args.eval_annotations):
        return None
    from ..eval import evaluate_captions
    eng = LlamaEngine(setup.model(), setup.cfg, max_len=args.max_length,
                      device=setup.trainer.device)
    gcfg = GenerationConfig(max_new_tokens=args.eval_max_new_tokens,
                            do_sample=False, num_beams=args.eval_num_beams,
                            eos_token_id=setup.tok.eos_token_id)
    with open(args.eval_annotations) as f:
        ann = {int(k): v for k, v in json.load(f).items()}
    return evaluate_captions(lambda prompts: eng.generate(prompts, gcfg),
                             setup.tok.decode, eval_prompts(args), ann,
                             max_batches=args.eval_batches)


def run(args, setup: Setup) -> Dict[str, Any]:
    """Train ``setup`` on the shards from its current state; returns the
    run's record (``entry.train_rounds``)."""
    def scored():
        scores = run_eval(args, setup)
        if scores is None:
            return None
        return scores[EVAL_KEY], {f"eval_{k}": v for k, v in scores.items()}

    data = Prefetcher(batch_stream(args, setup.tok), depth=2)
    try:
        return train_rounds(args, setup.trainer,
                            Feed(data, setup.trainer.device), StepLog(),
                            scored, higher_is_better=True,
                            deploy_tree=lambda: setup.trainer.state.params)
    finally:
        data.close()


def main(argv=None) -> Dict[str, Any]:
    args = parse_args(argv)
    return run(args, build(args))


if __name__ == "__main__":
    main()
