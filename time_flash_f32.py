"""Device times of the fp32 split-TF32 kernels, the flash forward, dq and
dk/dv at the fp32 training layer's shape and ``int8_matmul`` with fp32 x at
the 8B prefill's 4096 x 4096, on one NVIDIA GPU, from this checkout or from
another tree:

    python3 time_flash_f32.py [--tree DIR]

``--tree DIR`` imports ``seed_tpu_torch`` from DIR (for example an unpacked
``git archive`` of another commit, which builds its kernels into its own
``build/``), so that two commits can be timed in turns within one call:
parent, change, change, parent. The method is time_short_mha.py's and
chip_smoke.py's (``time_ms``: device time between CUDA events, the host's
time hidden, the L2 flushed before each call).

Flash shape: B=1, S=1024, H=32, D=128, causal, fp32 (``_TiledFlash`` on an
fp32 base). The forward is held against its plain version (2e-5 on o and
lse), dq and dk/dv against theirs (1e-4), then each is timed beside its
plain version, ``scaled_dot_product_attention`` in fp32 (its forward; its
whole backward, dq, dk and dv in one call) and the bound: 2·D operations a
(row, column) pair and product, each as three TF32 products at the TF32
tensor-core peak (the same operations on the fp32 FMA units apart, as
``bound_fp32_fma_ms``), every tensor once against the memory rate; then dq
and dk/dv called together against that backward. int8 shape:
x [256, 4096] fp32 @ an int8 [4096, 4096] weight, held against its plain
version (1e-5 of max|y|), timed beside ``x @ w_q.float() * scale``, the
GEMM on a weight converted before the timing (``gemm_ms``) and the bound
of 2·M·N·K operations as two TF32 products each at the TF32 peak (at the
fp32 FMA units' peak apart). One
JSON line per kernel with the card's name and power limit; a failed check
exits non-zero.

``--lengths`` reads instead how the fp32 flash kernels' error grows with
the sequence: B=1, D=128, S = 1024 to 8192 (H=4, 2 at 8192), causal and
not, the forward's o and lse, dq, dk and dv, each kernel and each plain
version against a float64 reference of the same attention, and kernel
against plain beside the limits (2e-5 forward, 1e-4 backward); it prints
and does not fail.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

import chip_smoke

B, S, H, D = 1, 1024, 32, 128
M, K, N = 256, 4096, 4096


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=None,
                        help="import seed_tpu_torch from this directory")
    parser.add_argument("--lengths", action="store_true",
                        help="read the fp32 flash errors against sequence "
                        "length instead of timing")
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
    from seed_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain
    from seed_tpu_torch.ops.quantization import quantize_weight
    if not Path(kernels.__file__).resolve().is_relative_to(tree):
        raise AssertionError(f"seed_tpu_torch came from {kernels.__file__}, "
                             f"not from {tree}")

    name = chip_smoke.card()
    if args.lengths:
        lengths(TF, tree, name)
        return
    reports = kernels.build(["flash_attention", "int8_matmul"])
    print(json.dumps({"tree": str(tree), "built": sorted(reports),
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
    dq_err = (TF.flash_bwd_dq(*bwd) - TF.flash_bwd_dq_plain(*bwd)).abs().max().item()
    dkv_err = max((a - b).abs().max().item() for a, b in
                  zip(TF.flash_bwd_dkv(*bwd), TF.flash_bwd_dkv_plain(*bwd)))
    if not max(dq_err, dkv_err) <= 1e-4:
        raise AssertionError(f"fp32 backward: max_abs_err dq {dq_err}, "
                             f"dk/dv {dkv_err} > 1e-4")

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
            "flash_bwd_dq": (3, 5 * tensor + 2 * rowvec, dq_err, lib_bwd,
                             lambda: TF.flash_bwd_dq(*bwd),
                             lambda: TF.flash_bwd_dq_plain(*bwd)),
            "flash_bwd_dkv": (4, 6 * tensor + 2 * rowvec, dkv_err, lib_bwd,
                              lambda: TF.flash_bwd_dkv(*bwd),
                              lambda: TF.flash_bwd_dkv_plain(*bwd))}
    for kernel, (products, nbytes, e, lib, fn, plain) in runs.items():
        flops = products * 2 * D * pairs
        print(json.dumps({
            "tree": str(tree), "kernel": kernel,
            "shape": dict(B=B, S=S, H=H, D=D, causal=True, dtype="float32"),
            "max_abs_err": e, "ms": chip_smoke.time_ms(fn, 20, flush),
            "plain_ms": chip_smoke.time_ms(plain, 2, flush),
            "library_ms": lib, "library": "scaled_dot_product_attention"
            + ("" if kernel == "flash_fwd" else " backward (dq, dk, dv)"),
            **chip_smoke.split_tf32_bounds(nbytes, flops, 3),
            "card": name}), flush=True)
    pair = chip_smoke.time_ms(lambda: (TF.flash_bwd_dq(*bwd),
                                       TF.flash_bwd_dkv(*bwd)), 20, flush)
    print(json.dumps({"tree": str(tree), "kernel": "flash_bwd_dq+flash_bwd_dkv",
                      "ms": pair, "library_ms": lib_bwd,
                      "ratio_to_library": pair / lib_bwd,
                      "library": "scaled_dot_product_attention backward "
                      "(dq, dk, dv)", "card": name}), flush=True)
    del q, k, v, dout, qt, kt, vt, gt, sdpa, want, out

    qw = quantize_weight(torch.randn(K, N, generator=gen, device="cuda") * 0.02)
    wq, sc = qw["kernel_q"], qw["scale"]
    x = torch.randn(M, K, generator=gen, device="cuda")
    got, ref = int8_matmul(x, wq, sc), int8_matmul_plain(x, wq, sc)
    rel = (got - ref).abs().max().item() / ref.abs().max().item()
    if not rel <= 1e-5:
        raise AssertionError(f"int8_matmul fp32: relative error {rel} > 1e-5")
    wx = wq.float()
    nbytes = M * K * 4 + K * N + N * 4 + M * N * 4
    flops = 2 * M * N * K
    print(json.dumps({
        "tree": str(tree), "kernel": "int8_matmul",
        "shape": dict(M=M, K=K, N=N, dtype="float32"), "rel_err": rel,
        "ms": chip_smoke.time_ms(lambda: int8_matmul(x, wq, sc), 20, flush),
        "plain_ms": chip_smoke.time_ms(lambda: int8_matmul_plain(x, wq, sc),
                                       20, flush),
        "library_ms": chip_smoke.time_ms(lambda: x @ wq.float() * sc, 20, flush),
        "library": "x @ w_q.float() * scale",
        "gemm_ms": chip_smoke.time_ms(lambda: x @ wx, 20, flush),
        "gemm": "x @ w_fp32, converted before the timing",
        **chip_smoke.split_tf32_bounds(nbytes, flops, 2),
        "card": name}), flush=True)


def _reference64(q, k, v, dout, causal, scale):
    """o, dq, dk, dv of softmax attention in float64, [B, S, H, D]."""
    q, k, v, dout = (t.double().permute(0, 2, 1, 3) for t in (q, k, v, dout))
    s = q @ k.transpose(-1, -2) * scale
    if causal:
        n = s.shape[-1]
        above = torch.ones(n, n, dtype=torch.bool, device=s.device).triu(1)
        s = s.masked_fill(above, float("-inf"))
    p = torch.softmax(s, -1)
    o = p @ v
    ds = p * (dout @ v.transpose(-1, -2) - (dout * o).sum(-1, keepdim=True))
    grads = (o, ds @ k * scale, ds.transpose(-1, -2) @ q * scale,
             p.transpose(-1, -2) @ dout)
    return [t.permute(0, 2, 1, 3) for t in grads]


def lengths(TF, tree: Path, name: str) -> None:
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 14)
    err = lambda a, b: (a.double() - b.double()).abs().max().item()
    for S_ in (1024, 2048, 4096, 8192):
        for causal in (True, False):
            H_ = 4 if S_ <= 4096 else 2
            q, k, v, dout = (torch.randn(1, S_, H_, D, generator=gen,
                                         device="cuda") for _ in range(4))
            scale = D ** -0.5
            o, lse = TF.flash_fwd(q, k, v, causal, scale)
            po, plse = TF.flash_fwd_plain(q, k, v, causal, scale)
            delta = (dout * po).sum(-1).permute(0, 2, 1).contiguous()
            bwd = (q, k, v, dout, plse, delta, causal, scale)
            got = [o, TF.flash_bwd_dq(*bwd), *TF.flash_bwd_dkv(*bwd)]
            plain = [po, TF.flash_bwd_dq_plain(*bwd),
                     *TF.flash_bwd_dkv_plain(*bwd)]
            ref = _reference64(q, k, v, dout, causal, scale)
            out = {"tree": str(tree), "S": S_, "H": H_, "causal": causal,
                   "lse": err(lse, plse), "card": name}
            for key, a, p_, r in zip(("o", "dq", "dk", "dv"), got, plain, ref):
                out[key] = dict(kernel_vs_plain=err(a, p_),
                                kernel_vs_f64=err(a, r), plain_vs_f64=err(p_, r),
                                max_abs=p_.abs().max().item(),
                                limit=2e-5 if key == "o" else 1e-4)
            print(json.dumps(out), flush=True)
            del q, k, v, dout, got, plain, ref
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
