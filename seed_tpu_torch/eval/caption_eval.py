"""Generation-based evaluation loops (counterpart of
seed_tpu/eval/caption_eval.py, CustomTrainer.evaluate in the reference):
generate over an eval stream, gather the results across processes, dedupe
by image_id, score with the caption metrics; and the code -> image ->
features harness of FID (eval_caption_to_images.py)."""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from .metrics import caption_metrics


def _to_host(x) -> np.ndarray:
    """A tensor (on any device) or array -> numpy; bf16 comes back fp32."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return np.asarray(x)


def gather_results(local: List[Dict]) -> List[Dict]:
    """Every process's records, in rank order (all_gather_object). In one
    process, or with no process group initialised, ``local`` itself."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return local
    parts: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(parts, local)
    return [r for part in parts for r in part]


def dedupe_by_key(results: List[Dict], key: str = "image_id") -> List[Dict]:
    seen, out = set(), []
    for r in results:
        if r[key] not in seen:
            seen.add(r[key])
            out.append(r)
    return out


def evaluate_captions(
    generate_fn: Callable[[List[List[int]]], List[List[int]]],
    decode_fn: Callable[[List[int]], str],
    eval_stream: Iterable[Dict[str, Any]],
    annotations: Dict[int, List[str]],
    max_batches: Optional[int] = None,
) -> Dict[str, float]:
    """``eval_stream`` yields {"input_ids": [B, N] prompts, "image_id": [B]}.
    Returns the BLEU / CIDEr metrics of the gathered, deduped generations."""
    local: List[Dict] = []
    for i, batch in enumerate(eval_stream):
        if max_batches is not None and i >= max_batches:
            break
        prompts = [list(map(int, row)) for row in batch["input_ids"]]
        outs = generate_fn(prompts)
        for img_id, out_ids in zip(batch["image_id"], outs):
            local.append({"image_id": int(img_id),
                          "caption": decode_fn(out_ids)})
    return caption_metrics(dedupe_by_key(gather_results(local)), annotations)


def generate_images_for_fid(
    decode_image_fn: Callable[[np.ndarray], Any],
    codes_stream: Iterable[Any],
    feature_fn: Callable[[Any], Any],
    max_batches: Optional[int] = None,
) -> np.ndarray:
    """Decode batches of codes to pixels and take their features for FID.
    The seed and guidance live inside ``decode_image_fn``; codes reach it
    as numpy, and the features come back to the host as numpy [N, D]."""
    feats = []
    for i, codes in enumerate(codes_stream):
        if max_batches is not None and i >= max_batches:
            break
        images = decode_image_fn(_to_host(codes))
        feats.append(_to_host(feature_fn(images)))
    return np.concatenate(feats, axis=0) if feats else np.zeros((0, 1))
