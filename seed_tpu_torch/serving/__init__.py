"""Serving of seed_tpu_torch: the generation engine and the interleaved
image/text interface."""
