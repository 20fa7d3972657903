"""SEED tokenizer training entry point, stages 1 and 2 (counterpart of
scripts/train_tokenizer.py, with its flags).

Stage 1 trains the causal Q-Former (ITC + ITM + captioning LM) behind the
frozen EVA-ViT; stage 2 trains the codebook path (encode_task -> VQ ->
decode_task, recon blocks, image-distill head) behind the frozen ViT and
Q-Former, regressing onto a frozen CLIP-ViT-H tower computed inline per
batch. Data: webdataset-style image (+ text) tars, decoded lazily and
resized with a JPEG draft decode. Checkpoints under ``<output>`` hold the
trainable leaves only (runner_base.py:411-434); the full train state goes
under ``<output>/state`` for ``--resume``; with ``--eval-data`` the
held-out loss at every save point picks the best checkpoint.

    python3 -m seed_tpu_torch.train.train_tokenizer --stage 1 \\
        --data 'cc3m/*.tar' --steps 100000 --batch-size 64 --lr 3e-5 \\
        --output ckpts/stage1

It runs on the card (``--device cuda``, the default) and raises where there
is none; ``--device cpu`` runs it on the CPU. The batches are made in a
background thread: on the card its device work (normalisation, and in
stage 2 the CLIP tower) runs on a CUDA stream of its own, and each batch is
finished before the step takes it. Under torchrun (or a process group its
caller has initialised) the Trainer shards the state over seed_tpu's
``auto_mesh()`` (FSDP over every rank, the automatic specs), each rank reads
its own share of the tars, ``--batch-size`` stays global, and rank 0 logs
and writes.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import logging
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..data import (Prefetcher, batched, decode_image_text,
                    decode_image_text_lazy, resize_draft, shuffle_buffer,
                    tar_source)
from ..data.pipeline import process_index_count
from ..models import SEED_TOKENIZER, TINY_TOKENIZER, init_seed_tokenizer
from ..models.qformer import init_lm_head
from ..models.vit import (CLIP_VIT_H, clip_image_embed,
                          init_clip_vision_projection, init_vit)
from ..ops.preprocess import preprocess
from ..parallel.local import whole
from ..serving.multimodal import ByteTextTokenizer
from ..utils.checkpoint import filter_tree, merge_tree, restore_checkpoint
from .entry import (Feed, StepLog, generator, rank_device, train_mesh,
                    train_rounds)
from .optim import adamw, masked_trainable, warmup_cosine, warmup_step_decay
from .tokenizer_training import (STAGE1_TRAINABLE, STAGE2_TRAINABLE,
                                  Stage1Config, Stage2Config, init_itm_head,
                                  init_stage1_head, stage1_total_loss,
                                  stage2_loss)
from .trainer import Trainer

log = logging.getLogger("seed_tpu_torch.train")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", type=int, choices=[1, 2], required=True)
    ap.add_argument("--arch", choices=["full", "tiny"], default="full",
                    help="tiny = smoke-test scale")
    ap.add_argument("--data", required=True)
    ap.add_argument("--init-ckpt", default=None,
                    help="stage 2 initializes from the stage-1 checkpoint")
    ap.add_argument("--steps", type=int, default=100000)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--max-text-len", type=int, default=32)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--warmup", type=int, default=5000)
    ap.add_argument("--lr-sched", choices=["cosine", "step"],
                    default="cosine",
                    help="LAVIS linear_warmup_cosine_lr (default) or "
                         "linear_warmup_step_lr")
    ap.add_argument("--lr-decay-rate", type=float, default=0.9,
                    help="per-epoch decay for --lr-sched step")
    ap.add_argument("--steps-per-epoch", type=int, default=10000,
                    help="epoch length driving the step schedule")
    ap.add_argument("--output", required=True)
    ap.add_argument("--save-steps", type=int, default=5000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--resume", action="store_true",
                    help="restore model, optimizer and step from "
                         "<output>/state and continue")
    ap.add_argument("--eval-data", default=None,
                    help="held-out tar glob: eval loss at every save point "
                         "picks the best checkpoint")
    ap.add_argument("--eval-batches", type=int, default=8)
    ap.add_argument("--distill-head", choices=["reverse_qformer", "image_down"],
                    default="reverse_qformer",
                    help="stage-2 image-distill head; reverse_qformer is the "
                         "reference training default")
    ap.add_argument("--flash-vit", action="store_true", default=True,
                    help="the frozen EVA-ViT's attention through the "
                         "short_mha kernel")
    ap.add_argument("--no-flash-vit", dest="flash_vit", action="store_false")
    ap.add_argument("--clip-ckpt", default=None,
                    help="frozen CLIP-ViT-H tower checkpoint for the stage-2 "
                         "distill target (random init if absent: smoke mode)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.arch == "tiny":
        args.image_size = TINY_TOKENIZER.vit.image_size
    return args


@dataclass
class Setup:
    tok_cfg: Any
    trainer: Trainer
    trainable: str                 # STAGE1_TRAINABLE or STAGE2_TRAINABLE
    loss_fn: Callable              # (params, batch, rng) -> (loss, metrics)
    clip: Optional[Callable]       # stage 2: images -> CLIP targets


def build(args) -> Setup:
    """Tokenizer tree (merged over ``--init-ckpt``), heads, the frozen CLIP
    tower of stage 2, optimizer and trainer on ``args.device``."""
    device = rank_device(resolve_device(args.device))
    mesh = train_mesh(device)
    lr = args.lr or (3e-5 if args.stage == 1 else 1e-4)  # the yaml defaults
    base_cfg = TINY_TOKENIZER if args.arch == "tiny" else SEED_TOKENIZER
    tok_cfg = dataclasses.replace(
        base_cfg,
        vit=dataclasses.replace(base_cfg.vit, use_flash=args.flash_vit),
        qformer=dataclasses.replace(base_cfg.qformer,
                                    with_text=(args.stage == 1)),
        with_recon_blocks=(args.stage == 2),
        use_qformer_image=(args.stage == 2
                           and args.distill_head == "reverse_qformer"))
    tok_params = init_seed_tokenizer(generator(device, args.seed), tok_cfg,
                                     torch.float32, device)
    if args.init_ckpt:
        # a checkpoint holds the trainable leaves only; merge it over the
        # fresh tree. A stage-1 checkpoint is {"tokenizer": ..., "head": ...}
        restored = restore_checkpoint(args.init_ckpt, device=device)
        if isinstance(restored, dict) and "tokenizer" in restored:
            restored = restored["tokenizer"]
        tok_params = merge_tree(tok_params, restored)

    clip = None
    if args.stage == 1:
        s1 = Stage1Config(tokenizer=tok_cfg)
        params = {"tokenizer": tok_params,
                  "head": init_stage1_head(generator(device, args.seed + 1),
                                           s1, device=device),
                  "itm_head": init_itm_head(generator(device, args.seed + 3),
                                            s1, device=device),
                  "lm_head": init_lm_head(generator(device, args.seed + 4),
                                          tok_cfg.qformer, device=device)}
        loss_fn = lambda p, batch, rng: stage1_total_loss(p, batch, rng, s1)
        trainable = STAGE1_TRAINABLE
    else:
        s2 = Stage2Config(tokenizer=tok_cfg)
        params = tok_params
        loss_fn = lambda p, batch, rng: stage2_loss(p, batch, rng, s2)
        trainable = STAGE2_TRAINABLE
        # the frozen CLIP-ViT-H target tower, computed inline per batch
        # (blip2_qformer_codebook_all_image.py:283-286)
        clip_cfg = (CLIP_VIT_H if args.arch == "full" else
                    dataclasses.replace(tok_cfg.vit, qkv_bias="full",
                                        ln_pre=True, patch_bias=False))
        if args.clip_ckpt:
            clip_params = restore_checkpoint(args.clip_ckpt, device=device)
        else:
            print("WARNING: no --clip-ckpt; random CLIP targets (smoke mode)")
            ck = generator(device, args.seed + 2)
            clip_params = {
                "vit": init_vit(ck, clip_cfg, torch.bfloat16, device),
                "head": init_clip_vision_projection(
                    ck, clip_cfg, tok_cfg.image_embed_dim, torch.bfloat16,
                    device)}

        @torch.no_grad()
        def clip(images: torch.Tensor) -> torch.Tensor:
            return clip_image_embed(clip_params["vit"], clip_params["head"],
                                    images.to(torch.bfloat16),
                                    clip_cfg).float()

    # frozen leaves get no update at all (a zero gradient alone would still
    # let AdamW's weight decay shrink them)
    if args.lr_sched == "step":
        sched = warmup_step_decay(lr, args.warmup, args.steps_per_epoch,
                                  decay_rate=args.lr_decay_rate)
    else:
        sched = warmup_cosine(lr, args.warmup, args.steps)
    opt = masked_trainable(
        adamw(sched, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.05,
              params=params), params, trainable)
    trainer = Trainer(loss_fn, params, opt, device=device, mesh=mesh)
    return Setup(tok_cfg, trainer, trainable, loss_fn, clip)


def example_stream(args, source=None):
    """Training images (resized to ``--image-size``) with their captions,
    forever; a payload that fails to decode is skipped."""
    source = source if source is not None else tar_source(
        args.data, decode=decode_image_text_lazy, cycle_count=None,
        seed=args.seed)
    for s in source:
        try:
            img = resize_draft(s["image"], args.image_size)
        except (OSError, SyntaxError, ValueError) as e:
            log.warning("skipping image %s: %s", s.get("__key__"), e)
            continue
        yield {"pixels": np.asarray(img, np.uint8), "text": s.get("text", ""),
               "clip_embed": s.get("clip_embed")}


def make_collate(args, setup: Setup, text_tok) -> Callable:
    """items -> batch on the device: {"images"} (fp32, normalised) plus
    {"text_ids", "text_pad"} in stage 1 or {"clip_embeds"} in stage 2 (the
    records' own, or the frozen CLIP tower's). On the card the work goes
    to a CUDA stream of the calling thread's own, finished before the
    batch is returned."""
    device = setup.trainer.device
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def collate(items):
        with torch.cuda.stream(side) if side else contextlib.nullcontext():
            pixels = torch.from_numpy(np.stack([i["pixels"] for i in items]))
            imgs = preprocess(pixels.to(device), args.image_size,
                              torch.float32)
            batch = {"images": imgs}
            if args.stage == 1:
                T = args.max_text_len
                ids = np.zeros((len(items), T), np.int32)
                pad = np.zeros((len(items), T), np.int32)
                for r, it in enumerate(items):
                    enc = text_tok.encode(it["text"])[:T]
                    ids[r, :len(enc)] = enc
                    pad[r, :len(enc)] = 1
                batch.update(text_ids=torch.from_numpy(ids).to(device),
                             text_pad=torch.from_numpy(pad).to(device))
            else:
                pre = [i.get("clip_embed") for i in items]
                if all(p is not None for p in pre):
                    batch["clip_embeds"] = torch.from_numpy(
                        np.stack(pre).astype(np.float32)).to(device)
                else:
                    batch["clip_embeds"] = setup.clip(imgs)
        if side is not None:
            side.synchronize()
        return batch
    return collate


def run_eval(args, setup: Setup, collate) -> Optional[float]:
    """The mean loss over ``--eval-batches`` held-out batches, or None
    without ``--eval-data``."""
    if not args.eval_data:
        return None
    source = tar_source(args.eval_data, decode=decode_image_text,
                        cycle_count=1, seed=args.seed)
    losses = []
    device = setup.trainer.device
    sharded = setup.trainer.mesh is not None
    if sharded:                 # the batch is plain, the params DTensors
        from torch.distributed.tensor.experimental import implicit_replication
    with torch.no_grad(), implicit_replication() if sharded else \
            contextlib.nullcontext():
        for i, batch in enumerate(batched(example_stream(args, source),
                                          args.batch_size, collate)):
            if i >= args.eval_batches:
                break
            loss, _ = setup.loss_fn(setup.trainer.state.params, batch,
                                    generator(device, i))
            losses.append(float(whole(loss)))
    return float(np.mean(losses)) if losses else None


def run(args, setup: Setup) -> Dict[str, Any]:
    """Train ``setup`` on the image tars from its current state; returns the
    run's record (``entry.train_rounds``)."""
    collate = make_collate(args, setup, ByteTextTokenizer())

    def scored():
        loss = run_eval(args, setup, collate)
        return None if loss is None else (loss, {"eval_loss": loss})

    local_batch = args.batch_size // process_index_count()[1]
    data = Prefetcher(batched(shuffle_buffer(example_stream(args), 2000,
                                             args.seed),
                              local_batch, collate), depth=2)
    try:
        return train_rounds(
            args, setup.trainer, Feed(data, setup.trainer.device), StepLog(),
            scored, higher_is_better=False,
            deploy_tree=lambda: filter_tree(setup.trainer.state.params,
                                            setup.trainable))
    finally:
        data.close()


def main(argv=None) -> Dict[str, Any]:
    args = parse_args(argv)
    return run(args, build(args))


if __name__ == "__main__":
    main()
