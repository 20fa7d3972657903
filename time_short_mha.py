"""Device times of the short_mha kernel at the port's main shapes, on one
NVIDIA GPU, from this checkout or from another tree:

    python3 time_short_mha.py [--tree DIR]

``--tree DIR`` imports ``seed_tpu_torch`` from DIR (for example an unpacked
``git archive`` of another commit, which builds its kernels into its own
``build/``), so that two commits can be timed in turns within one call:
parent, change, change, parent. The timing method is chip_smoke.py's
(``time_ms``: device time between CUDA events, the host's time hidden, the
L2 flushed before each call).

Cases: fp32 at ``train_tokenizer`` stage 1's shape (B=16, S=257, H=16, D=88,
q/k/v strided views of one fused projection), fast epilogue (the path's) and
exact; bf16 at the ViT encode's, B=8 (the chat and smoke encodes) and B=256
(the pre-tokenization batch), exact (the default encode's) and fast. Each is
held against its plain version first (2e-5 in fp32, 2**-6 in bf16) and timed
beside it, ``scaled_dot_product_attention`` on the same inputs and the bound
(4 B H S^2 D operations at the io type's peak, q, k, v and o once). A bf16
line names the design that ran (``design``: one pass, or recompute per
pass, the only design of a tree whose library does not report it). One JSON
line per case with the card's name and power limit; a failed check exits
non-zero.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

import chip_smoke

# (dtype, B, exact): the tokenizer training's fp32 call, the encode's bf16
CASES = [(torch.float32, 16, False), (torch.float32, 16, True),
         (torch.bfloat16, 8, True), (torch.bfloat16, 8, False),
         (torch.bfloat16, 256, True), (torch.bfloat16, 256, False)]
S, H, D = 257, 16, 88
TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -6}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=None,
                        help="import seed_tpu_torch from this directory")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_short_mha: needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    tree = Path(args.tree or Path(__file__).resolve().parent).resolve()
    sys.path.insert(0, str(tree))
    torch.backends.cuda.matmul.allow_tf32 = False
    import torch.nn.functional as F
    from seed_tpu_torch.ops import kernels
    from seed_tpu_torch.ops import flash_attention as TF
    from seed_tpu_torch.ops.flash_attention import short_mha, short_mha_plain
    if not Path(kernels.__file__).resolve().is_relative_to(tree):
        raise AssertionError(f"seed_tpu_torch came from {kernels.__file__}, "
                             f"not from {tree}")

    name = chip_smoke.card()
    reports = kernels.build(["short_mha"])
    print(json.dumps({"tree": str(tree), "built": bool(reports),
                      "ptxas": chip_smoke.ptxas_usage(reports), "card": name}),
          flush=True)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 11)
    for dtype, B, exact in CASES:
        q, k, v = chip_smoke._qkv_views(gen, B, S, H, D, dtype)
        scale = D ** -0.5
        got = short_mha(q, k, v, scale, exact)
        want = short_mha_plain(q, k, v, scale, exact)
        err = (got.float() - want.float()).abs().max().item()
        if not err <= TOL[dtype]:
            raise AssertionError(f"short_mha {dtype} exact={exact}: "
                                 f"max_abs_err {err} > {TOL[dtype]}")
        design, lib = None, TF._lib()
        if dtype == torch.bfloat16:     # a tree without the query has one
            one_pass = (hasattr(lib, "seed_short_mha_bf16_one_pass") and
                        lib.seed_short_mha_bf16_one_pass(S, D, TF._mode(exact, D)))
            design = "one_pass" if one_pass else "recompute"
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        bms, by = chip_smoke.bound_ms(4 * B * S * H * D * dtype.itemsize,
                                      4 * B * H * S * S * D,
                                      chip_smoke.PEAK_FLOPS[dtype])
        print(json.dumps({
            "tree": str(tree), "kernel": "short_mha",
            "shape": dict(B=B, S=S, H=H, D=D, exact=exact,
                          dtype=str(dtype).split(".")[-1]),
            "design": design, "max_abs_err": err, "tol": TOL[dtype],
            "ms": chip_smoke.time_ms(lambda: short_mha(q, k, v, scale, exact),
                                     20, flush),
            "plain_ms": chip_smoke.time_ms(
                lambda: short_mha_plain(q, k, v, scale, exact), 10, flush),
            "library_ms": chip_smoke.time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt), 20, flush),
            "bound_ms": bms, "bound_by": by, "card": name}), flush=True)


if __name__ == "__main__":
    main()
