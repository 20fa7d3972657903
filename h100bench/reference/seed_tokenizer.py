"""Plain fp32 reference of the SEED-2 tokenizer's encode: CLIP
normalisation of uint8 pixels, EVA-ViT (patch embedding as one matmul, cls
token, positions, pre-norm blocks with q and v biases, erf GELU), the fp32
``ln_vision`` LayerNorm, the causal Q-Former (learned queries, post-norm
self-attention causal among the queries, cross-attention to the image
features every ``cross_freq`` layers, FFN), ``encode_task`` (tanh between
two linears) and the VQ distances ``|z - e|^2`` over the codebook.

Plain PyTorch in fp32 with TF32 off; it imports nothing of the program and
reads only the benchmark's own weights and pixels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
FP8_MAX = 448.0


def _fp8_rows(x: torch.Tensor) -> torch.Tensor:
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _f(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def _ln(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], _f(p["scale"]), _f(p["bias"]), eps)


def _attend(q, k, v, heads: int, causal: bool) -> torch.Tensor:
    B, N, D = q.shape
    M, hd = k.shape[1], D // heads
    q = q.view(B, N, heads, hd).transpose(1, 2)
    k = k.view(B, M, heads, hd).transpose(1, 2)
    v = v.view(B, M, heads, hd).transpose(1, 2)
    s = q @ k.transpose(-1, -2) * hd ** -0.5
    if causal:
        mask = torch.ones(N, M, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    return (s.softmax(-1) @ v).transpose(1, 2).reshape(B, N, D)


@torch.no_grad()
def features(w: dict, spec: dict, pixels: torch.Tensor, act) -> torch.Tensor:
    """uint8 [B, S, S, 3] -> pre-VQ features z [B, Q, code_dim] (fp32)."""
    v, q = spec["vit"], spec["qformer"]
    lin = lambda p, x: act(x) @ _f(p["kernel"]) + (
        _f(p["bias"]) if "bias" in p else 0.0)
    mean = torch.tensor(CLIP_MEAN, device=pixels.device)
    std = torch.tensor(CLIP_STD, device=pixels.device)
    x = (pixels.float() / 255.0 - mean) / std
    B, S, _, C = x.shape
    p = v["patch_size"]
    g = S // p
    x = x.view(B, g, p, g, p, C).permute(0, 1, 3, 2, 4, 5).reshape(B, g * g, -1)
    vt = w["vit"]
    x = lin(vt["patch_embed"], x)
    x = torch.cat([_f(vt["cls_token"]).expand(B, 1, -1), x], 1) \
        + _f(vt["pos_embed"])
    d = v["dim"]
    for blk in vt["blocks"]:
        h = _ln(blk["norm1"], x, v["ln_eps"])
        a = blk["attn"]
        qkv = lin(a["qkv"], h)
        if "q_bias" in a:
            qkv = qkv + torch.cat([_f(a["q_bias"]), torch.zeros(d, device=x.device),
                                   _f(a["v_bias"])])
        qq, kk, vv = qkv.split(d, dim=-1)
        x = x + lin(a["proj"], _attend(qq, kk, vv, v["heads"], False))
        h = _ln(blk["norm2"], x, v["ln_eps"])
        x = x + lin(blk["mlp"]["fc2"], F.gelu(lin(blk["mlp"]["fc1"], h)))
    img = _ln(w["ln_vision"], x, 1e-5)
    qf, eps = w["qformer"], q["ln_eps"]
    y = _ln(qf["embeddings"]["norm"],
            _f(qf["query_tokens"]).expand(B, -1, -1), eps)

    def attn(pp, xq, xkv, causal):
        o = _attend(lin(pp["q"], xq), lin(pp["k"], xkv), lin(pp["v"], xkv),
                    q["heads"], causal)
        return _ln(pp["norm"], xq + lin(pp["out"], o), eps)

    for layer in qf["layers"]:
        y = attn(layer["self"], y, y, True)
        if "cross" in layer:
            y = attn(layer["cross"], y, img, False)
        f = layer["ffn_q"]
        y = _ln(f["norm"], y + lin(f["fc2"], F.gelu(lin(f["fc1"], y))), eps)
    t = w["encode_task"]
    return lin(t["fc2"], torch.tanh(lin(t["fc1"], y)))


def distances(codebook: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """|z - e_j|^2 for every code j: [..., n_codes]."""
    d = torch.cdist(z.reshape(-1, z.shape[-1]), codebook.float(),
                    compute_mode="donot_use_mm_for_euclid_dist")
    return d.square().view(*z.shape[:-1], -1)


def compare(w: dict, spec: dict, pixels: torch.Tensor, answers: list,
            device, control: bool = False, block: int = 32) -> dict:
    """The program's answers against the reference, image by image: the
    widest relative feature error ``|z - z_ref| / |z_ref|``, and the widest
    code gap, by how much the chosen code's reference distance exceeds the
    nearest code's.

    ``pixels`` [N, S, S, 3] uint8; ``answers``: (first row, features z
    [B, Q, D], ids [B, Q]) of each compared call, its rows of ``pixels``
    from the first on. With ``control`` the reference computed one
    precision below bf16 (every product's activation operand rounded to
    fp8 e4m3, one scale per row) is the one answer, for all of ``pixels``."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        run = lambda act: torch.cat([features(w, spec, pixels[a:a + block], act)
                                     for a in range(0, len(pixels), block)])
        zr = run(lambda t: t)
        d = distances(w["vq"]["codebook"], zr)
        if control:
            zc = run(_fp8_rows)
            answers = [(0, zc, distances(w["vq"]["codebook"], zc).argmin(-1))]
        feat, gap, n = 0.0, 0.0, 0
        for a, z, ids in answers:
            b = a + len(z)
            err = ((z.float() - zr[a:b]).flatten(1).norm(dim=1)
                   / zr[a:b].flatten(1).norm(dim=1))
            g = (d[a:b].gather(-1, ids.long()[..., None])[..., 0]
                 - d[a:b].min(-1).values)
            feat, gap = max(feat, float(err.max())), max(gap, float(g.max()))
            n += len(z)
        return {"feature_err": feat, "code_gap": gap, "images": n}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
