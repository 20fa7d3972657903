"""Serving of seed_tpu_torch: the generation engine, the continuous-batching
scheduler, the interleaved image/text interface and the HTTP service."""
from .conversation import (CONV_LLAMA_2, CONV_SEED_LLAMA, Conversation,
                           SeparatorStyle)
from .engine import GenerationConfig, LlamaEngine
from .multimodal import (ByteTextTokenizer, HFTextTokenizer, PromptTemplate,
                         Segment, SeedLlamaInterface, codes_to_string,
                         image_ids_to_tokens, segments_to_string,
                         string_to_parts)
from .offload import OffloadedParams, ResidentParams, wrap_params
from .scheduler import ContinuousBatcher, Request, ScheduledEngine

__all__ = [
    "CONV_LLAMA_2", "CONV_SEED_LLAMA", "Conversation", "SeparatorStyle",
    "GenerationConfig", "LlamaEngine",
    "ByteTextTokenizer", "HFTextTokenizer", "PromptTemplate", "Segment",
    "SeedLlamaInterface", "image_ids_to_tokens",
    "codes_to_string", "string_to_parts", "segments_to_string",
    "ContinuousBatcher", "Request", "ScheduledEngine",
    "OffloadedParams", "ResidentParams", "wrap_params",
]
