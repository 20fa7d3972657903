"""The SEED-2 image tokenizer encoding images through the port, closed loop.

The timed call is what ``data/extract_image_ids`` and
``scripts/seed_tokenizer_inference`` run on a batch of uint8 pixels on the
card: ``ops/preprocess.preprocess`` (to 224, CLIP normalisation, bf16), then
``models/seed_tokenizer.encode`` (EVA-ViT-g, ``ln_vision``, the causal
Q-Former, ``encode_task``, fp32 VQ argmin), and the ids read back to the
host. The default ``SEED_TOKENIZER`` config: plain ``mha``, erf GELU, bf16.

The benchmark makes the weights (bf16, in a few large draws on the card)
and a pool of pixel batches from the seed; the same tensors go to the
program and to the reference.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import List

import numpy as np
import torch

from h100bench.core.bench import reference_module
from h100bench.core.work import seed_encode_flops


def leaves(spec: dict) -> list:
    """(path, shape, init) of every leaf an encode reads, in the port's tree
    layout. init: ("w", fan_in) | "b" | "ln_s" | "ln_b" | "tok" | "cb"."""
    v, q = spec["vit"], spec["qformer"]
    d, m, h = v["dim"], v["mlp_dim"], q["hidden"]
    n = (v["image_size"] // v["patch_size"]) ** 2 + 1
    out = []

    def lin(path, k, o, bias=True):
        out.append((path + ("kernel",), (k, o), ("w", k)))
        if bias:
            out.append((path + ("bias",), (o,), "b"))

    def ln(path, dim):
        out.append((path + ("scale",), (dim,), "ln_s"))
        out.append((path + ("bias",), (dim,), "ln_b"))

    lin(("vit", "patch_embed"), v["patch_size"] ** 2 * 3, d)
    out.append((("vit", "cls_token"), (1, 1, d), "tok"))
    out.append((("vit", "pos_embed"), (1, n, d), "tok"))
    for i in range(v["depth"]):
        b = ("vit", "blocks", i)
        ln(b + ("norm1",), d)
        lin(b + ("attn", "qkv"), d, 3 * d, bias=v["qkv_bias"] == "full")
        if v["qkv_bias"] == "qv":
            out.append((b + ("attn", "q_bias"), (d,), "b"))
            out.append((b + ("attn", "v_bias"), (d,), "b"))
        lin(b + ("attn", "proj"), d, d)
        ln(b + ("norm2",), d)
        lin(b + ("mlp", "fc1"), d, m)
        lin(b + ("mlp", "fc2"), m, d)
    ln(("ln_vision",), d)
    out.append((("qformer", "query_tokens"), (1, q["query_len"], h), "tok"))
    ln(("qformer", "embeddings", "norm"), h)
    for i in range(q["layers"]):
        b = ("qformer", "layers", i)
        for part, kv_in in (("self", h), ("cross", q["encoder_width"])):
            if part == "cross" and i % q["cross_freq"]:
                continue
            lin(b + (part, "q"), h, h)
            lin(b + (part, "k"), kv_in, h)
            lin(b + (part, "v"), kv_in, h)
            lin(b + (part, "out"), h, h)
            ln(b + (part, "norm"), h)
        lin(b + ("ffn_q", "fc1"), h, q["intermediate"])
        lin(b + ("ffn_q", "fc2"), q["intermediate"], h)
        ln(b + ("ffn_q", "norm"), h)
    lin(("encode_task", "fc1"), h, h)
    lin(("encode_task", "fc2"), h, spec["code_dim"])
    out.append((("vq", "codebook"), (spec["codebook_size"], spec["code_dim"]),
                "cb"))
    return out


def _set(tree: dict, path: tuple, value) -> None:
    for i, k in enumerate(path[:-1]):
        nxt = path[i + 1]
        if isinstance(k, int):
            while len(tree) <= k:
                tree.append({})
            tree = tree[k]
        else:
            tree = tree.setdefault(k, [] if isinstance(nxt, int) else {})
    tree[path[-1]] = value


@torch.no_grad()
def make_weights(spec: dict, seed: int, device) -> dict:
    """Seeded bf16 weights, one draw per kind of leaf: linear kernels with
    std fan_in^-1/2 (one scaling per fan-in), biases std 0.02, LayerNorm
    scales 1 +- 0.05 and biases std 0.02, tokens and positions std 0.02, the
    codebook std ``codebook_std`` (entries at the features' scale)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    ls = leaves(spec)
    key = lambda lf: ("w", lf[2][1]) if isinstance(lf[2], tuple) else (lf[2], 0)
    ls.sort(key=key)
    total = sum(int(np.prod(s)) for _, s, _ in ls)
    buf = torch.randn(total, generator=g, dtype=torch.bfloat16, device=device)
    tree: dict = {}
    off, groups = 0, {}
    for path, shape, init in ls:
        n = int(np.prod(shape))
        k = key((path, shape, init))
        a, _ = groups.get(k, (off, 0))
        groups[k] = (a, off + n)
        _set(tree, path, buf[off:off + n].view(shape))
        off += n
    for (kind, fan), (a, b) in groups.items():
        seg = buf[a:b]
        if kind == "w":
            seg.mul_(fan ** -0.5)
        elif kind == "ln_s":
            seg.mul_(0.05).add_(1.0)
        elif kind == "cb":
            seg.mul_(float(spec["codebook_std"]))
        else:
            seg.mul_(0.02)
    return tree


def program_config(spec: dict):
    from seed_tpu_torch.models.qformer import QFormerConfig
    from seed_tpu_torch.models.seed_tokenizer import SEED_TOKENIZER
    from seed_tpu_torch.models.vit import ViTConfig
    v, q = spec["vit"], spec["qformer"]
    return dataclasses.replace(
        SEED_TOKENIZER,
        vit=ViTConfig(image_size=v["image_size"], patch_size=v["patch_size"],
                      dim=v["dim"], depth=v["depth"], heads=v["heads"],
                      mlp_dim=v["mlp_dim"], qkv_bias=v["qkv_bias"],
                      act=v["act"], ln_eps=v["ln_eps"]),
        qformer=QFormerConfig(hidden=q["hidden"], layers=q["layers"],
                              heads=q["heads"], intermediate=q["intermediate"],
                              encoder_width=q["encoder_width"],
                              cross_freq=q["cross_freq"],
                              query_len=q["query_len"], ln_eps=q["ln_eps"]),
        codebook_size=spec["codebook_size"], code_dim=spec["code_dim"])


class TokenizerCell:
    def __init__(self, config: dict, mix: dict, seed: int, seconds: float,
                 device, tracer):
        import seed_tpu_torch.models.quantizer as VQ
        from seed_tpu_torch.models.seed_tokenizer import encode
        from seed_tpu_torch.ops.preprocess import preprocess
        self.config, self.mix, self.seed = config, mix, seed
        self.seconds = float(seconds)
        self.device = torch.device(device)
        self.tracer = tracer
        self.spec = config
        self.batch = int(mix["batch"])
        self.cfg = program_config(config)
        self.weights = make_weights(config, seed, self.device)
        g = torch.Generator(device=self.device)
        g.manual_seed(seed + 1)
        size = config["vit"]["image_size"]
        self.pool = torch.randint(
            0, 256, (int(mix["pool"]), self.batch, size, size, 3),
            generator=g, dtype=torch.uint8, device=self.device)
        self._z: List[torch.Tensor] = []
        nearest = VQ.nearest_codes

        def keep_features(codebook, z):
            self._z.append(z)
            return nearest(codebook, z)

        # the timed path's own pre-VQ features, kept for the check
        VQ.nearest_codes = keep_features
        self._restore = lambda: setattr(VQ, "nearest_codes", nearest)
        dtype = getattr(torch, config["dtype"])

        def call(pixels):
            imgs = preprocess(pixels, size, dtype)
            return encode(self.weights, imgs, self.cfg).cpu()

        self.call = call
        tracer.wrap(self, "call", "encode",
                    lambda pixels: {"images": int(pixels.shape[0])})
        self.calls: List[tuple] = []      # (pool index, ids, features)
        self.attempted = self.failed = 0

    @torch.inference_mode()
    def warm(self) -> None:
        for i in range(2):
            self.call(self.pool[i % len(self.pool)])
        self._z.clear()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    @torch.inference_mode()
    def window(self, t_start: float) -> None:
        """One caller, each call after the last has returned, until the
        window's time is up; the window ends with the last call, so the rate
        is over whole calls."""
        tr = self.tracer
        prof = self.mix.get("profile", {})
        p0 = int(prof.get("start_call", 1))
        p1 = p0 + int(prof.get("calls", 1))
        ws = time.perf_counter()
        self.setup_s = ws - t_start
        we = ws + self.seconds
        k = 0
        while time.perf_counter() < we or (tr.profiling and k < p1):
            if tr.on and k == p0:
                tr.start_profile()
            i = k % len(self.pool)
            ids = self.call(self.pool[i])
            self.calls.append((i, ids, self._z.pop()))
            k += 1
            if tr.profiling and k == p1:
                tr.stop_profile()
        self.t_end = time.perf_counter()
        self.window_bounds = (ws, self.t_end)
        self.ws = ws
        self.attempted = k * self.batch

    def end_to_end(self) -> dict:
        return {"images_per_s": len(self.calls) * self.batch
                / (self.t_end - self.ws), "setup_s": self.setup_s}

    def summary(self) -> dict:
        return {"calls": len(self.calls), "images": len(self.calls) * self.batch,
                "window_s": self.t_end - self.ws, "setup_s": self.setup_s,
                "encode_gflop_per_image": seed_encode_flops(self.spec) / 1e9}

    def release(self) -> None:
        self._restore()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> list:
        """Calls of the window drawn from the seed, until they hold the
        check's number of images."""
        want = int(self.config["check"]["images"])
        rng = np.random.default_rng(self.seed + 7)
        picked = []
        for j in rng.permutation(len(self.calls)):
            if len(picked) * self.batch >= want:
                break
            picked.append(self.calls[j])
        return picked

    def _readings(self, control: bool = False) -> dict:
        """The reference runs once on each distinct pool batch the sample
        holds; every sampled call's answer is compared with its rows."""
        picked = self.sample()
        idx = sorted({i for i, _, _ in picked})
        row = {i: k * self.batch for k, i in enumerate(idx)}
        pixels = self.pool[idx].flatten(0, 1)
        answers = [(row[i], z, ids.to(self.device)) for i, ids, z in picked]
        return reference_module("seed_tokenizer").compare(
            self.weights, self.spec, pixels, answers, self.device,
            control=control)

    def check(self) -> list:
        r = self._readings()
        lim = self.config["check"]
        print(json.dumps({"compared": r}), flush=True)
        return [{"name": "feature_err", "value": r["feature_err"],
                 "limit": lim["feature_err"]},
                {"name": "code_gap", "value": r["code_gap"],
                 "limit": lim["code_gap"]}]

    def control(self) -> dict:
        return self._readings(control=True)


def build(config, mix, seed, seconds, device, tracer) -> TokenizerCell:
    return TokenizerCell(config, mix, seed, seconds, device, tracer)
