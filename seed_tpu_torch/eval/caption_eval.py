"""Generation-based caption evaluation (counterpart of
seed_tpu/eval/caption_eval.py, CustomTrainer.evaluate in the reference):
generate over an eval stream, gather the results across processes, dedupe
by image_id, score with the caption metrics."""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional

from .metrics import caption_metrics


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
