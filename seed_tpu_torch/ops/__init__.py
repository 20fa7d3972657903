"""Ops of seed_tpu_torch: attention, the CUDA kernels and their plain
versions, quantization, preprocessing, sampling."""
