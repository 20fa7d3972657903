"""Offline image -> token-id pre-tokenization, the bridge from pixels to the
LLM's training data (counterpart of scripts/extract_image_ids.py, with its
flags and ``--device``).

Streams webdataset-style image tars, encodes them with the SEED tokenizer
(bf16, on the card by default) and writes pkl tar shards of records
``{__key__, image_ids, text, metadata[, clip_embed]}``, the format
``train_llm`` reads (the LLM never sees pixels). The images come through the
native loader (``seed_tpu_torch.native``: tar index, batched reads, parallel
libjpeg decode) when it is available, else through ``tar_source`` and PIL,
as the script chooses; a background thread keeps batches ahead of the
encode. Each process reads its share of the tars (``shard_for_host``) and
names its shards ``host{index}_{n:05d}.tar``. The tail batch is padded to
the batch shape. ``--emit-clip-embeds`` adds the frozen CLIP-ViT-H embedding
of each image (the stage-2 distill target).

    python3 -m seed_tpu_torch.data.extract_image_ids --input 'data/*.tar' \\
        --output out/ --checkpoint ckpts/tokenizer --batch-size 256
"""
from __future__ import annotations

import argparse
import io
import os
import pickle
import tarfile
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from .pipeline import (Prefetcher, batched, decode_image_text, list_shards,
                       process_index_count, shard_for_host, tar_source)


def write_shard(path, records):
    with tarfile.open(path, "w") as tf:
        for i, rec in enumerate(records):
            data = pickle.dumps(rec)
            info = tarfile.TarInfo(f"{rec.get('__key__', i)}.pkl")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


def pixel_batches(pattern: str, batch_size: int, image_size: int):
    """(loader, batches): "native" (the C++ loader, when it builds) or
    "python" (tar_source + PIL), and a Prefetcher of lists of records
    ``{__key__, pixels, text, meta}``."""
    from .. import native
    if native.available():
        files = shard_for_host(list_shards(pattern))

        def native_stream():
            for imgs, keys, texts in native.fast_image_batches(
                    files, batch_size, image_size):
                yield [{"__key__": k, "pixels": im, "text": t, "meta": {}}
                       for im, k, t in zip(imgs, keys, texts)]

        return "native", Prefetcher(native_stream(), depth=4)

    def to_pixels(sample):
        img = sample["image"].resize((image_size, image_size))
        return {"__key__": sample["__key__"],
                "pixels": np.asarray(img, np.uint8),
                "text": sample.get("text", ""),
                "meta": sample.get("meta", {})}

    stream = (to_pixels(s) for s in
              tar_source(pattern, decode=decode_image_text, cycle_count=1))
    return "python", Prefetcher(batched(stream, batch_size, drop_last=False),
                                depth=4)


def run(params, cfg, inputs: str, output: str, batch_size: int = 256,
        image_size: int = 224, shard_size: int = 10000, clip=None,
        device="cuda", dtype=torch.bfloat16) -> Dict[str, Any]:
    """Encode every image of the tars ``inputs`` into shards under
    ``output``. ``clip``: None, or (vit params, head params, ViT config) of
    the frozen CLIP tower whose embedding each record also gets. Returns
    {"images", "shards", "loader", "seconds", "wait_s"} (``wait_s``: the
    time the encode loop waited for the loader) and the same three counts
    after the first batch (``warm_images``, ``warm_seconds``,
    ``warm_wait_s``; None for a single batch), which leave out the first
    calls' set-up."""
    from ..models import encode
    from ..models.vit import clip_image_embed
    from ..ops.preprocess import preprocess

    device = resolve_device(device)
    os.makedirs(output, exist_ok=True)
    host = process_index_count()[0]
    loader, batches = pixel_batches(inputs, batch_size, image_size)
    records, shards, total, waited = [], [], 0, 0.0
    t0 = time.perf_counter()
    first = None                # (time, images, wait) after the first batch

    def flush(recs):
        path = os.path.join(output, f"host{host}_{len(shards):05d}.tar")
        write_shard(path, recs)
        shards.append(path)

    try:
        it = iter(batches)
        while True:
            tw = time.perf_counter()
            batch = next(it, None)
            waited += time.perf_counter() - tw
            if batch is None:
                break
            pixels = np.stack([b["pixels"] for b in batch])
            n = len(batch)
            if n < batch_size:        # pad the tail batch to the batch shape
                pad = np.zeros((batch_size - n, *pixels.shape[1:]), np.uint8)
                pixels = np.concatenate([pixels, pad])
            with torch.inference_mode():
                imgs = preprocess(torch.from_numpy(pixels).to(device),
                                  image_size, dtype)
                ids = encode(params, imgs, cfg)[:n].cpu().numpy()
                embs = ([None] * n if clip is None else clip_image_embed(
                    clip[0], clip[1], imgs, clip[2]).float()[:n].cpu().numpy())
            for rec, row, emb in zip(batch, ids, embs):
                out = {"__key__": rec["__key__"],
                       "image_ids": row.astype(np.int32).tolist(),
                       "text": rec["text"], "metadata": rec["meta"]}
                if emb is not None:
                    out["clip_embed"] = emb.astype(np.float32)
                records.append(out)
            total += n
            if first is None:   # the ids are on the host: the batch is done
                first = (time.perf_counter(), total, waited)
            while len(records) >= shard_size:
                flush(records[:shard_size])
                records = records[shard_size:]
        if records:
            flush(records)
    finally:
        batches.close()
    end = time.perf_counter()
    warm = first is not None and total > first[1]
    return {"images": total, "shards": shards, "loader": loader,
            "seconds": end - t0, "wait_s": waited,
            "warm_images": total - first[1] if warm else None,
            "warm_seconds": end - first[0] if warm else None,
            "warm_wait_s": waited - first[2] if warm else None}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--input", required=True, help="glob of input image tars")
    ap.add_argument("--output", required=True)
    ap.add_argument("--checkpoint", default=None,
                    help="tokenizer checkpoint dir; random init if absent")
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--shard-size", type=int, default=10000)
    ap.add_argument("--emit-clip-embeds", action="store_true",
                    help="also write the frozen CLIP-ViT-H image embedding "
                         "per record (the stage-2 distill target)")
    ap.add_argument("--clip-ckpt", default=None,
                    help="CLIP-ViT-H tower checkpoint (random init if absent)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> Dict[str, Any]:
    from ..models import SEED_TOKENIZER, init_seed_tokenizer
    from ..utils.checkpoint import restore_checkpoint
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = SEED_TOKENIZER
    if args.checkpoint:
        params = restore_checkpoint(args.checkpoint, device=device)
    else:
        print("WARNING: no checkpoint given; using random init (smoke mode)")
        params = init_seed_tokenizer(torch.Generator(device).manual_seed(0),
                                     cfg, torch.bfloat16, device)
    clip = None
    if args.emit_clip_embeds:
        from ..models.vit import (CLIP_VIT_H, init_clip_vision_projection,
                                  init_vit)
        if args.clip_ckpt:
            cp = restore_checkpoint(args.clip_ckpt, device=device)
        else:
            print("WARNING: no --clip-ckpt; random CLIP embeds (smoke mode)")
            ck = torch.Generator(device).manual_seed(1)
            cp = {"vit": init_vit(ck, CLIP_VIT_H, torch.bfloat16, device),
                  "head": init_clip_vision_projection(
                      ck, CLIP_VIT_H, cfg.image_embed_dim, torch.bfloat16,
                      device)}
        clip = (cp["vit"], cp["head"], CLIP_VIT_H)
    res = run(params, cfg, args.input, args.output, args.batch_size,
              args.image_size, args.shard_size, clip, device)
    print(f"done: {res['images']} images in {res['seconds']:.3f}s "
          f"({res['loader']} loader, waited {res['wait_s']:.3f}s for it)",
          flush=True)
    if res["warm_images"]:
        print(f"after the first batch: {res['warm_images']} images in "
              f"{res['warm_seconds']:.3f}s (waited {res['warm_wait_s']:.3f}s "
              f"for the loader)", flush=True)
    return res


if __name__ == "__main__":
    main()
