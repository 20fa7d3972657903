"""Device times of the fp32 flash forward and dk/dv kernels at the fp32
training layer's shape, on one NVIDIA GPU, from this checkout or from
another tree:

    python3 time_flash_f32.py [--tree DIR]

``--tree DIR`` imports ``seed_tpu_torch`` from DIR (for example an unpacked
``git archive`` of another commit, which builds its kernels into its own
``build/``), so that two commits can be timed in turns within one call:
parent, change, change, parent. The method is time_short_mha.py's and
chip_smoke.py's (``time_ms``: device time between CUDA events, the host's
time hidden, the L2 flushed before each call).

Shape: B=1, S=1024, H=32, D=128, causal, fp32 (``_TiledFlash`` on an fp32
base). The forward is held against its plain version (2e-5 on o and lse),
dk/dv against its plain version (1e-4), then each is timed beside its plain
version, ``scaled_dot_product_attention`` in fp32 (its forward; its whole
backward, dq, dk and dv in one call) and two bounds: 2·D operations a
(row, column) pair and product against the fp32 peak, and three times those
against the TF32 tensor-core peak, every tensor once against the memory
rate. One JSON line per kernel with the card's name and power limit; a
failed check exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

import chip_smoke

B, S, H, D = 1, 1024, 32, 128


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=None,
                        help="import seed_tpu_torch from this directory")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_flash_f32: needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    tree = Path(args.tree or Path(__file__).resolve().parent).resolve()
    sys.path.insert(0, str(tree))
    torch.backends.cuda.matmul.allow_tf32 = False
    import torch.nn.functional as F
    from seed_tpu_torch.ops import flash_attention as TF
    from seed_tpu_torch.ops import kernels
    if not Path(kernels.__file__).resolve().is_relative_to(tree):
        raise AssertionError(f"seed_tpu_torch came from {kernels.__file__}, "
                             f"not from {tree}")

    name = chip_smoke.card()
    reports = kernels.build(["flash_attention"])
    print(json.dumps({"tree": str(tree), "built": bool(reports),
                      "ptxas": chip_smoke.ptxas_usage(reports), "card": name}),
          flush=True)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 13)
    q, k, v, dout = (torch.randn(B, S, H, D, generator=gen, device="cuda")
                     for _ in range(4))
    scale = D ** -0.5
    out, lse = TF.flash_fwd(q, k, v, True, scale)
    want, want_lse = TF.flash_fwd_plain(q, k, v, True, scale)
    err = max((out - want).abs().max().item(), (lse - want_lse).abs().max().item())
    if not err <= 2e-5:
        raise AssertionError(f"flash_fwd fp32: max_abs_err {err} > 2e-5")
    delta = (dout * want).sum(-1).permute(0, 2, 1).contiguous()
    bwd = (q, k, v, dout, want_lse, delta, True, scale)
    dkv_err = max((a - b).abs().max().item() for a, b in
                  zip(TF.flash_bwd_dkv(*bwd), TF.flash_bwd_dkv_plain(*bwd)))
    if not dkv_err <= 1e-4:
        raise AssertionError(f"flash_bwd_dkv fp32: max_abs_err {dkv_err} > 1e-4")

    qt, kt, vt, gt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v, dout))
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib_fwd = chip_smoke.time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 20, flush)
    lib_bwd = chip_smoke.time_ms(lambda: torch.autograd.grad(
        sdpa, (qt, kt, vt), gt, retain_graph=True), 20, flush)
    pairs = B * H * chip_smoke._pairs(S, S, True, 0)
    tensor, rowvec = B * S * H * D * 4, B * H * S * 4
    runs = {"flash_fwd": (2, 4 * tensor + rowvec, err, lib_fwd,
                          lambda: TF.flash_fwd(q, k, v, True, scale),
                          lambda: TF.flash_fwd_plain(q, k, v, True, scale)),
            "flash_bwd_dkv": (4, 6 * tensor + 2 * rowvec, dkv_err, lib_bwd,
                              lambda: TF.flash_bwd_dkv(*bwd),
                              lambda: TF.flash_bwd_dkv_plain(*bwd))}
    for kernel, (products, nbytes, e, lib, fn, plain) in runs.items():
        flops = products * 2 * D * pairs
        bms, by = chip_smoke.bound_ms(nbytes, flops, chip_smoke.FP32_FLOPS)
        print(json.dumps({
            "tree": str(tree), "kernel": kernel,
            "shape": dict(B=B, S=S, H=H, D=D, causal=True, dtype="float32"),
            "max_abs_err": e, "ms": chip_smoke.time_ms(fn, 20, flush),
            "plain_ms": chip_smoke.time_ms(plain, 2, flush),
            "library_ms": lib, "library": "scaled_dot_product_attention"
            + ("" if kernel == "flash_fwd" else " backward (dq, dk, dv)"),
            "bound_ms": bms, "bound_by": by,
            "bound_tf32x3_ms": chip_smoke.bound_ms(nbytes, 3 * flops,
                                                   chip_smoke.TF32_FLOPS)[0],
            "card": name}), flush=True)


if __name__ == "__main__":
    main()
