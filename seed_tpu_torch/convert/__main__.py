"""Convert released PyTorch checkpoints into seed_tpu_torch checkpoints.

    python3 -m seed_tpu_torch.convert quantizer seed_quantizer.pt out/tokenizer
    python3 -m seed_tpu_torch.convert llama path/to/hf_dir out/llm --pad-vocab 40320
    python3 -m seed_tpu_torch.convert lora adapter_model.bin out/lora
    python3 -m seed_tpu_torch.convert unclip path/to/diffusers_dir out/unclip

A directory source is read file by file: every ``*.safetensors`` in it, else
every ``*.bin``, else every ``*.pt``. The ``unclip`` family reads the
subdirectories ``unet``, ``vae``, ``text_encoder`` and ``image_normalizer``
of a diffusers stable-diffusion-2-1-unclip directory. When the text encoder
is there it also runs it once on the empty prompt (BOS, EOS, then the SD
2.x tokenizer's pad id, ``!`` = 0, up to 77 tokens; heads of dim 64, as in
every CLIP text tower) and stores the result as ``empty_prompt_embeds``,
the context that ``UnCLIPDecoder`` conditions on. The output is one checkpoint
directory (``utils.checkpoint.save_checkpoint``), read back by
``restore_checkpoint`` and by the server's ``--llm-ckpt``,
``--tokenizer-ckpt`` and ``--diffusion-ckpt``. The conversion runs on
``--device`` (the card unless ``--device cpu``).
"""
from __future__ import annotations

import argparse
import glob
import os
import sys

import torch

CLIP_BOS, CLIP_EOS, CLIP_PAD = 49406, 49407, 0
CLIP_HEAD_DIM = 64


def load_dir_or_file(path: str):
    from .torch_convert import load_torch_state_dict
    if not os.path.isdir(path):
        return load_torch_state_dict(path)
    files = (glob.glob(os.path.join(path, "*.safetensors"))
             or glob.glob(os.path.join(path, "*.bin"))
             or glob.glob(os.path.join(path, "*.pt")))
    sd = {}
    for f in sorted(files):
        sd.update(load_torch_state_dict(f))
    return sd


@torch.inference_mode()
def empty_prompt_embeds(text) -> torch.Tensor:
    """The converted text tower on the empty prompt -> [1, max_len, hidden]."""
    from ..models.unclip import CLIPTextConfig, clip_text_apply
    vocab, hidden = text["token_embedding"]["embedding"].shape
    max_len = text["position_embedding"]["embedding"].shape[0]
    cfg = CLIPTextConfig(vocab_size=vocab, hidden=hidden,
                         layers=len(text["layers"]),
                         heads=hidden // CLIP_HEAD_DIM,
                         mlp_dim=text["layers"][0]["fc1"]["kernel"].shape[1],
                         max_len=max_len)
    ids = torch.full((1, max_len), CLIP_PAD, dtype=torch.long,
                     device=text["final_ln"]["scale"].device)
    ids[0, :2] = torch.tensor([CLIP_BOS, CLIP_EOS])
    return clip_text_apply(text, ids, cfg)


def convert(args) -> dict:
    from . import torch_convert as TC
    from . import unclip_convert as UC
    if args.family == "quantizer":
        return TC.convert_quantizer(load_dir_or_file(args.src), device=args.device)
    if args.family == "llama":
        from ..models.llama import pad_vocab
        sd = load_dir_or_file(args.src)
        embed = sd.get("model.embed_tokens.weight", sd.get("embed_tokens.weight"))
        return TC.convert_llama(sd, args.pad_vocab or pad_vocab(embed.shape[0]),
                                device=args.device)
    if args.family == "lora":
        return TC.convert_lora(load_dir_or_file(args.src), device=args.device)
    tree = {}
    for sub, fn in (("unet", UC.convert_unet), ("vae", UC.convert_vae_decoder),
                    ("text_encoder", UC.convert_clip_text),
                    ("image_normalizer", UC.convert_image_normalizer)):
        subdir = os.path.join(args.src, sub)
        if os.path.isdir(subdir):
            tree[sub] = fn(load_dir_or_file(subdir), device=args.device)
        else:
            print(f"warning: {subdir} missing, skipping {sub}", file=sys.stderr)
    if "text_encoder" in tree:
        tree["empty_prompt_embeds"] = empty_prompt_embeds(tree["text_encoder"])
    return tree


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python3 -m seed_tpu_torch.convert",
        description="released PyTorch checkpoints -> seed_tpu_torch checkpoints")
    ap.add_argument("family", choices=["quantizer", "llama", "lora", "unclip"])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--pad-vocab", type=int, default=None,
                    help="llama: pad the vocabulary rows to this many "
                         "(default: the next multiple of 128)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from ..utils.checkpoint import save_checkpoint
    save_checkpoint(args.dst, convert(args))
    print(f"converted {args.family}: {args.src} -> {args.dst}")


if __name__ == "__main__":
    main()
