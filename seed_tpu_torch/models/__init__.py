"""Model definitions of seed_tpu_torch (plain functions over dicts of
tensors, mirroring seed_tpu.models)."""
