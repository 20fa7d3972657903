"""Merge a LoRA adapter into the base LLaMA weights and save (counterpart
of scripts/merge_lora.py: merge_and_unload -> save_pretrained).

    python3 -m seed_tpu_torch.scripts.merge_lora --base ckpts/llm \\
        --lora ckpts/lora --output ckpts/llm_merged

Three layouts are read:

- seed_tpu's single tree ``{"base": ..., "lora": ...}`` at ``--base`` (the
  script's layout; ``--lora`` is then not read);
- a bare base at ``--base`` and an adapter tree at ``--lora`` (from
  ``python3 -m seed_tpu_torch.convert lora``);
- the port's ``train_llm --lora`` checkpoint, which holds ``{"lora":
  adapters}`` only, at ``--lora`` (its adapters are that tree's
  ``"lora"``), with the base at ``--base``.

The merge runs on ``--device`` (the card unless ``--device cpu``).
"""
from __future__ import annotations

import argparse
from typing import Any, Tuple

from .. import resolve_device
from ..train.lora import merge_lora_weights
from ..utils.checkpoint import restore_checkpoint, save_checkpoint


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m seed_tpu_torch.scripts.merge_lora",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, help="llama checkpoint")
    ap.add_argument("--lora", required=True,
                    help="lora checkpoint (python3 -m seed_tpu_torch.convert "
                         "lora for PEFT .bin files, or a train_llm --lora "
                         "save)")
    ap.add_argument("--output", required=True)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def load_pair(base_path: str, lora_path: str, device) -> Tuple[Any, Any]:
    """(base, adapters) from the checkpoints in any of the three layouts."""
    base = restore_checkpoint(base_path, device=device)
    if isinstance(base, dict) and set(base) == {"base", "lora"}:
        return base["base"], base["lora"]
    lora = restore_checkpoint(lora_path, device=device)
    if isinstance(lora, dict) and set(lora) == {"lora"}:
        lora = lora["lora"]
    return base, lora


def main(argv=None) -> Any:
    args = parse_args(argv)
    device = resolve_device(args.device)
    base, lora = load_pair(args.base, args.lora, device)
    merged = merge_lora_weights(base, lora)
    save_checkpoint(args.output, merged)
    print(f"merged -> {args.output}")
    return merged


if __name__ == "__main__":
    main()
