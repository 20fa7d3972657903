"""Evaluation of seed_tpu_torch (counterpart of seed_tpu.eval): FID and the
Inception Score over the Inception-v3 network, the caption and VQA metrics,
the eval readers and the generation loops."""
from .caption_eval import (dedupe_by_key, evaluate_captions, gather_results,
                           generate_images_for_fid)
from .eval_readers import (CAPTION_PROMPT, VQA_PROMPT_SUFFIX,
                           caption_eval_stream, edit_eval_stream,
                           evaluate_vqa, iter_json_records,
                           load_video_frames, sample_frames,
                           video_eval_stream, vqa_eval_stream)
from .inception import (INCEPTION_CONVS, inception_logits, inception_pool3,
                        inception_probs, init_inception,
                        resize_bilinear_align_corners)
from .metrics import (bleu, caption_metrics, cider_d, fid, frechet_distance,
                      gaussian_stats, inception_score, vqa_accuracy)

__all__ = ["INCEPTION_CONVS", "inception_logits", "inception_pool3",
           "inception_probs", "init_inception",
           "resize_bilinear_align_corners",
           "bleu", "caption_metrics", "cider_d", "fid", "frechet_distance",
           "gaussian_stats", "inception_score", "vqa_accuracy",
           "dedupe_by_key", "evaluate_captions", "gather_results",
           "generate_images_for_fid",
           "CAPTION_PROMPT", "VQA_PROMPT_SUFFIX",
           "caption_eval_stream", "edit_eval_stream", "evaluate_vqa",
           "iter_json_records", "load_video_frames", "sample_frames",
           "video_eval_stream", "vqa_eval_stream"]
