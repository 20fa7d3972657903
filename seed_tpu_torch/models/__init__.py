"""Model definitions of seed_tpu_torch (plain functions over dicts of
tensors, mirroring seed_tpu.models). The unCLIP de-tokenizer is the
subpackage ``models.unclip``."""
from .seed_tokenizer import (SEED_TOKENIZER, TINY_TOKENIZER,
                             SeedTokenizerConfig, decode_embedding, encode,
                             encode_features, encode_to_embedding,
                             init_seed_tokenizer)

__all__ = [
    "SEED_TOKENIZER", "TINY_TOKENIZER", "SeedTokenizerConfig",
    "decode_embedding", "encode", "encode_features", "encode_to_embedding",
    "init_seed_tokenizer",
]
