"""Training data of seed_tpu_torch (counterpart of seed_tpu.data): tar
shards through composable generators (``pipeline``) and the example
builders of every pretrain and SFT source (``builders``). Plain Python and
numpy; nothing here touches a device."""
from .builders import (GENERATION_PROMPTS, build_caption_example,
                       build_conversation_example, build_edit_example,
                       build_interleaved_example, build_multi_edit_example,
                       build_multi_image_qa_example,
                       build_retrieval_augmented_example, build_story_example,
                       build_text_conversation_example, build_video_example,
                       build_video_conversation_example,
                       build_visual_instruction_example, clean_caption,
                       collate, image_token_ids, match_interleaved_images)
from .pipeline import (Prefetcher, batched, cycle, decode_image_text,
                       decode_image_text_lazy, decode_pkl_records,
                       group_by_key, iter_tar, list_shards, lmdb_ids_source,
                       multiplexer_longest, quality_filter, resize_draft,
                       sample_multiplexer, shard_for_host, shuffle_buffer,
                       tar_source)

__all__ = [
    "GENERATION_PROMPTS",
    "build_caption_example", "build_conversation_example",
    "build_edit_example", "build_interleaved_example",
    "build_multi_edit_example", "build_multi_image_qa_example",
    "build_retrieval_augmented_example", "build_story_example",
    "build_text_conversation_example", "build_video_example",
    "build_video_conversation_example", "build_visual_instruction_example",
    "clean_caption", "collate", "image_token_ids", "match_interleaved_images",
    "Prefetcher", "batched", "cycle", "decode_image_text",
    "decode_image_text_lazy", "decode_pkl_records", "group_by_key",
    "iter_tar", "list_shards", "lmdb_ids_source", "multiplexer_longest",
    "quality_filter", "resize_draft", "sample_multiplexer", "shard_for_host",
    "shuffle_buffer", "tar_source",
]
