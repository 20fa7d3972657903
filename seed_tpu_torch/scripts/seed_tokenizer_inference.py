"""Tokenize and de-tokenize one image (counterpart of
scripts/seed_tokenizer_inference.py, with its flags): the image's 32 ids,
their unCLIP embedding and, with ``--diffusion-ckpt``, the pixels the SD2.1
unCLIP decoder makes of it, saved to ``--save``.

    python3 -m seed_tpu_torch.scripts.seed_tokenizer_inference \\
        --image images/cat.jpg --tokenizer-ckpt ckpts/tokenizer \\
        --diffusion-ckpt ckpts/unclip --save out.jpg

Without ``--tokenizer-ckpt`` the SEED tokenizer takes seeded bf16 weights
(seed 0). The encode is bf16 at the default config (plain attention), as the
script's. It runs on the card (``--device cuda``, the default) and raises
where there is none.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models import seed_tokenizer as ST
from ..models.unclip import SD21_UNCLIP, UnCLIPConfig, UnCLIPDecoder
from ..ops.preprocess import preprocess
from ..utils.checkpoint import restore_checkpoint
from .seed_llama_inference import read_image


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python3 -m seed_tpu_torch.scripts.seed_tokenizer_inference",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--image", required=True)
    ap.add_argument("--tokenizer-ckpt", default=None)
    ap.add_argument("--diffusion-ckpt", default=None)
    ap.add_argument("--save", default="reconstruction.jpg")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


@torch.inference_mode()
def tokenize(params, raw: torch.Tensor, cfg: ST.SeedTokenizerConfig,
             dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 [B, H, W, 3] -> (ids [B, 32], unCLIP embeddings [B, 1024])."""
    ids = ST.encode(params, preprocess(raw, cfg.vit.image_size, dtype), cfg)
    return ids, ST.decode_embedding(params, ids, cfg)


def reconstruct(unclip_params, emb: torch.Tensor,
                cfg: UnCLIPConfig = SD21_UNCLIP, device="cuda") -> np.ndarray:
    """unCLIP embeddings [B, D] -> uint8 images [B, H, W, 3] (20 DDIM steps,
    guidance 10, the decoder's fixed latents)."""
    images = UnCLIPDecoder(unclip_params, cfg, device=device).generate(emb)
    return (images * 255).astype(np.uint8)


def main(argv=None, tok_cfg: ST.SeedTokenizerConfig = ST.SEED_TOKENIZER,
         unclip_cfg: UnCLIPConfig = SD21_UNCLIP) -> Dict[str, Any]:
    """The command line; ``tok_cfg`` and ``unclip_cfg`` name the configs of
    the checkpoints (the script's SEED_TOKENIZER and SD21_UNCLIP)."""
    from PIL import Image
    args = parse_args(argv)
    device = resolve_device(args.device)
    params = (restore_checkpoint(args.tokenizer_ckpt, device=device)
              if args.tokenizer_ckpt else
              ST.init_seed_tokenizer(
                  torch.Generator(device=device).manual_seed(0), tok_cfg,
                  torch.bfloat16, device))
    ids, emb = tokenize(params, read_image(args.image, device), tok_cfg)
    print("token ids:", ids[0].tolist())
    print("unCLIP embedding:", tuple(emb.shape))
    out = {"ids": ids.cpu().numpy(), "embedding": emb, "image": None}
    if args.diffusion_ckpt:
        unclip = restore_checkpoint(args.diffusion_ckpt, device=device)
        out["image"] = reconstruct(unclip, emb, unclip_cfg, device)[0]
        Image.fromarray(out["image"]).save(args.save)
        print("saved", args.save)
    else:
        print("no --diffusion-ckpt: skipping pixel reconstruction")
    return out


if __name__ == "__main__":
    main()
