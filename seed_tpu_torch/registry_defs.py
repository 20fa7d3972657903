"""The registry's names (counterpart of seed_tpu/registry_defs.py): the
constructors ``configs/*.json`` name, each building the port's object.

    import seed_tpu_torch.registry_defs  # registers the names
    from seed_tpu_torch.utils.registry import instantiate, load_config
    params, cfg = instantiate(load_config("configs/seed_llama_8b_8bit.json"))

Models take ``device`` (the card by default) and a ``seed`` for their
random weights when no checkpoint is given; the weights come from a
``torch.Generator`` on that device, not from seed_tpu's PRNG streams.
"""
from __future__ import annotations

import torch

from . import resolve_device
from .utils.registry import register


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


@register("seed_tokenizer")
def make_seed_tokenizer(checkpoint=None, arch="full", dtype="bfloat16",
                        seed=0, device="cuda"):
    """(params, SeedTokenizerConfig) of the SEED tokenizer."""
    from .models import SEED_TOKENIZER, TINY_TOKENIZER, init_seed_tokenizer
    from .utils.checkpoint import restore_checkpoint
    cfg = TINY_TOKENIZER if arch == "tiny" else SEED_TOKENIZER
    if checkpoint:
        return restore_checkpoint(checkpoint, device=device), cfg
    return init_seed_tokenizer(_generator(seed, device), cfg, _dtype(dtype),
                               device), cfg


@register("seed_llama")
def make_seed_llama(model="8b", checkpoint=None, dtype="bfloat16", seed=0,
                    int8=False, device="cuda"):
    """(params, LlamaConfig) of SEED-LLaMA. With ``int8`` and no checkpoint
    each layer is quantized as soon as it is made, so the full-precision
    model is never held whole; the leaves equal ``quantize_tree`` of the
    full-precision init from the same seed."""
    from .models import llama as M
    from .ops.quantization import DEFAULT_TARGETS, quantize_tree
    from .utils.checkpoint import restore_checkpoint
    cfg = {"8b": M.SEED_LLAMA_8B, "14b": M.SEED_LLAMA_14B,
           "tiny": M.TINY_LLAMA}[model]
    if checkpoint:
        params = restore_checkpoint(checkpoint, device=device)
        return (quantize_tree(params) if int8 else params), cfg
    return M.init_llama(_generator(seed, device), cfg, _dtype(dtype), device,
                        quantize_targets=DEFAULT_TARGETS if int8 else None
                        ), cfg


@register("unclip_decoder")
def make_unclip_decoder(checkpoint=None, num_inference_steps=20,
                        guidance_scale=10.0, seed=42, device="cuda"):
    """The SD2.1 unCLIP de-tokenizer (``UnCLIPDecoder``); random weights
    from seed 0 without a checkpoint, the latents from ``seed``."""
    from .models.unclip import SD21_UNCLIP, UnCLIPDecoder, init_unclip
    from .utils.checkpoint import restore_checkpoint
    params = (restore_checkpoint(checkpoint, device=device) if checkpoint
              else init_unclip(_generator(0, device), SD21_UNCLIP,
                               device=device))
    return UnCLIPDecoder(params, SD21_UNCLIP,
                         num_inference_steps=num_inference_steps,
                         guidance_scale=guidance_scale, seed=seed,
                         device=device)


@register("clip_transform")
def make_clip_transform(image_size=224, dtype="bfloat16"):
    """uint8 [B, H, W, 3] -> resized, CLIP-normalized ``dtype`` images, on
    the images' device."""
    import functools
    from .ops.preprocess import preprocess
    return functools.partial(preprocess, image_size=image_size,
                             dtype=_dtype(dtype))


@register("caption_datapipe")
def make_caption_datapipe(pattern, batch_size=64, max_length=128,
                          reverse_ratio=0.5, mask_left_label=False,
                          cycle_count=None, seed=0, shuffle=4096):
    import random
    from .data import (batched, build_caption_example, collate,
                       shuffle_buffer, tar_source)
    from .serving import ByteTextTokenizer
    tok = ByteTextTokenizer()
    rng = random.Random(seed)

    def stream():
        for rec in tar_source(pattern, cycle_count=cycle_count, seed=seed):
            ex = build_caption_example(rec, tok, max_length, reverse_ratio,
                                       mask_left_label, rng=rng)
            if ex is not None:
                yield ex

    return batched(shuffle_buffer(stream(), shuffle, seed), batch_size,
                   collate)


@register("multi_datapipe")
def make_multi_datapipe(sources, weights=None, seed=0):
    """Weighted mixture of named datapipes (build_multi_datapipes,
    torchdata_train.py:363-385)."""
    from .data import sample_multiplexer
    from .utils.registry import instantiate
    pipes = {name: instantiate(cfg) for name, cfg in sources.items()}
    return sample_multiplexer(pipes, weights or {}, seed)
