"""seed_tpu_torch — the SEED / SEED-LLaMA stack of ``seed_tpu`` in PyTorch,
with its kernels written by hand in CUDA for an NVIDIA H100 (sm_90a).

The layout mirrors ``seed_tpu`` so each function has a counterpart of the same
name there:

- ``seed_tpu_torch.models``  — EVA-ViT, causal Q-Former, VQ codebook, SEED
  tokenizer, LLaMA decoder + KV cache (plain functions over dicts of tensors)
- ``seed_tpu_torch.ops``     — attention, the CUDA kernels and their plain
  PyTorch versions, int8 quantization, preprocessing, sampling
- ``seed_tpu_torch.serving`` — generation engine + interleaved image/text API
- ``seed_tpu_torch.bridge``  — ``seed_tpu`` param trees (as numpy) -> tensors

The package imports torch, numpy and the standard library only. Entry points
run on the card (``device="cuda"``) unless the caller asks for the CPU.
"""
import torch

__version__ = "0.1.0"

BOI_TOKEN = "<img>"
EOI_TOKEN = "</img>"
IMG_TOKEN = "<img_{:05d}>"
IMG_FLAG = "<image>"
NUM_IMG_TOKENS = 32
NUM_IMG_CODES = 8192
# Vocabulary layout of the reference's string-space fusion
# (scripts/seed_llama_inference_8B.py:18-23): text ids 0..31999, image-code
# ids 32000..40191 (code k <-> id 32000+k), then BOI/EOI; the LLaMA embedding
# is padded to 40320 (a multiple of 128) with the padding logits masked.
IMAGE_ID_SHIFT = 32000
BOI_TOKEN_ID = 32000 + NUM_IMG_CODES      # 40192
EOI_TOKEN_ID = BOI_TOKEN_ID + 1           # 40193
VOCAB_SIZE = EOI_TOKEN_ID + 1             # 40194


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises when it names CUDA and this
    machine has none. Nothing in the package falls back to the CPU on its
    own: callers that want the CPU pass ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but CUDA is not available on this "
            "machine; pass device='cpu' to run seed_tpu_torch on the CPU")
    return dev
