"""Full-geometry check: the bytes each rank holds for the real 8B / 14B
training state at tp=2 x fsdp=4 (counterpart of
scripts/check_full_geometry.py, with its flags), computed on the ``meta``
device: no tensor is allocated and no process group is started.

    python3 -m seed_tpu_torch.scripts.check_full_geometry            # LoRA
    python3 -m seed_tpu_torch.scripts.check_full_geometry --full     # full

The param tree (and, unless ``--full``, ``init_lora(r=16, alpha=32)`` on
it) is laid out by ``parallel.partition``'s ``LLAMA_TP_RULES`` at the mesh
(data 1, fsdp devices / tp, pipe 1, tensor tp), given to
``make_param_specs`` as a mapping of axis sizes. Per rank it counts:

- parameters: the base (bf16) and the adapters (fp32);
- gradients of the trained leaves only (the adapters under LoRA, every leaf
  with ``--full``), in each leaf's dtype: the trainer takes no gradient of a
  frozen leaf;
- AdamW's two moments of the trained leaves, in the leaf's dtype
  (``train/optim.py``);
- the global batch (``--batch`` x ``--seq`` of int32 input_ids,
  attention_mask and labels, as ``train_llm`` feeds them) split over
  (data, fsdp).

Their sum is held against the H100's 80 GB, and every spec that does not
divide a true dim is listed. seed_tpu's script also reports XLA's estimate of
the compiled step's temporaries (activations, the remat buffers, the
collectives' staging); nothing here has that number without running the
step, so it is named as not estimated, not guessed.
"""
from __future__ import annotations

import argparse
import math
from typing import Dict, List, Tuple

import torch

from .. import resolve_device
from ..models import llama as M
from ..parallel.mesh import (AXIS_NAMES, DATA_AXIS, FSDP_AXIS, PIPE_AXIS,
                             TENSOR_AXIS)
from ..parallel.partition import LLAMA_TP_RULES, make_param_specs
from ..train.lora import init_lora
from ..utils.tree import leaves_with_path

MODELS = {"8b": M.SEED_LLAMA_8B, "14b": M.SEED_LLAMA_14B}
H100_BYTES = 80e9          # H100 SXM 80GB
BATCH_BYTES_PER_TOKEN = 3 * 4      # int32 input_ids, attention_mask, labels
GIB = 2 ** 30


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python3 -m seed_tpu_torch.scripts.check_full_geometry",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=["8b", "14b"], default="8b")
    ap.add_argument("--full", action="store_true",
                    help="full finetune (no LoRA): the heavier state")
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--devices", type=int, default=8, choices=(8, 16, 32),
                    help="device count; fsdp gets devices/tp")
    ap.add_argument("--batch", type=int, default=8, help="global batch")
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--device", default="cuda",
                    help="the card whose name and memory are printed beside "
                         "the count (the count itself allocates nothing)")
    return ap.parse_args(argv)


def mesh_sizes(devices: int, tp: int) -> Dict[str, int]:
    """seed_tpu's ``auto_mesh(tp=)``: data 1, fsdp the rest, tensor tp."""
    if devices % tp:
        raise ValueError(f"{devices} devices not divisible by tp={tp}")
    return {DATA_AXIS: 1, FSDP_AXIS: devices // tp, PIPE_AXIS: 1,
            TENSOR_AXIS: tp}


def state_trees(cfg: M.LlamaConfig, full: bool, r: int = 16, alpha: int = 32):
    """(every param the ranks hold, the leaves the optimizer trains) as meta
    trees: ``{"base", "lora"}`` and the adapters under LoRA, the base and
    itself with ``full``."""
    base = M.init_llama(torch.Generator(), cfg, torch.bfloat16, device="meta")
    if full:
        return base, base
    lora = init_lora(torch.Generator(), base, r=r, alpha=alpha)
    return {"base": base, "lora": lora}, {"lora": lora}


def sharded_bytes(tree, sizes: Dict[str, int]) -> Tuple[int, List[str]]:
    """(bytes one rank holds of ``tree`` under LLAMA_TP_RULES at ``sizes``,
    the specs that do not divide their dim). A dim sharded over axes whose
    sizes do not divide it is counted at its ceiling share."""
    specs = dict(leaves_with_path(make_param_specs(tree, sizes,
                                                   LLAMA_TP_RULES)))
    total, undivided = 0, []
    for path, leaf in leaves_with_path(tree):
        shape = list(leaf.shape)
        for dim, entry in enumerate(specs[path]):
            names = (entry,) if isinstance(entry, str) else (entry or ())
            n = math.prod(sizes[a] for a in names)
            if shape[dim] % n:
                undivided.append(f"{path} dim {dim} ({shape[dim]}) over "
                                 f"{'x'.join(names)} ({n})")
            shape[dim] = -(-shape[dim] // n)
        total += math.prod(shape) * leaf.element_size()
    return total, undivided


def state_bytes(cfg: M.LlamaConfig, full: bool,
                sizes: Dict[str, int]) -> Tuple[Dict[str, int], List[str]]:
    """({params, grads, adam_moments}: bytes one rank holds, the undivided
    specs) of ``cfg``'s training state at the mesh ``sizes``."""
    params, trained = state_trees(cfg, full)
    param_bytes, undivided = sharded_bytes(params, sizes)
    grad_bytes, _ = sharded_bytes(trained, sizes)
    return ({"params": param_bytes, "grads": grad_bytes,
             "adam_moments": 2 * grad_bytes}, undivided)


def geometry(model: str, full: bool, tp: int, devices: int, batch: int,
             seq: int) -> Dict:
    """Per-rank bytes of the training state and the batch, and the
    undivided specs."""
    sizes = mesh_sizes(devices, tp)
    parts, undivided = state_bytes(MODELS[model], full, sizes)
    parts["batch"] = -(-batch * seq * BATCH_BYTES_PER_TOKEN
                       // (sizes[DATA_AXIS] * sizes[FSDP_AXIS]))
    return dict(model=model, lora=not full,
                mesh={a: sizes[a] for a in AXIS_NAMES}, bytes=parts,
                total_bytes=sum(parts.values()), undivided=undivided)


def report(g: Dict) -> None:
    print(f"mesh: {g['mesh']}")
    print(f"{g['model']} {'LoRA r=16' if g['lora'] else 'full finetune'}: "
          "per-rank memory, from the partition specs:")
    for name, n in g["bytes"].items():
        print(f"  {name:<12}: {n / GIB:.2f} GiB")
    print("  temporaries : not estimated (activations, recompute buffers and "
          "collective staging need the step to run)")
    verdict = "FITS" if g["total_bytes"] < H100_BYTES else "EXCEEDS"
    print(f"  state total : {g['total_bytes'] / GIB:.2f} GiB ({verdict} one "
          f"H100 80GB before temporaries)")
    for line in g["undivided"]:
        print(f"  spec does not divide: {line}")
    if not g["undivided"]:
        print("  every spec divides its dim")


def main(argv=None) -> Dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    g = geometry(args.model, args.full, args.tp, args.devices, args.batch,
                 args.seq)
    report(g)
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        print(f"  this card   : {props.name}, "
              f"{props.total_memory / GIB:.2f} GiB")
    return g


if __name__ == "__main__":
    main()
