"""Evaluation of seed_tpu_torch (counterpart of seed_tpu.eval): the caption
metrics and the generation loop the LLM training entry point evaluates with
at every save point."""
from .caption_eval import dedupe_by_key, evaluate_captions, gather_results
from .eval_readers import iter_json_records
from .metrics import bleu, caption_metrics, cider_d

__all__ = ["bleu", "caption_metrics", "cider_d", "dedupe_by_key",
           "evaluate_captions", "gather_results", "iter_json_records"]
