"""Real-weight acceptance runbook: checkpoints in, one pass / fail JSON
report out (counterpart of scripts/acceptance.py, with its flags).

    python3 -m seed_tpu_torch.scripts.acceptance --out acceptance_out \\
        --quantizer seed_quantizer.pt \\
        --llama path/to/vicuna-7b-delta-merged \\
        --unclip path/to/stable-diffusion-2-1-unclip \\
        --text-tokenizer path/to/llama_tokenizer \\
        [--corpus images_dir] [--golden-pixels ref.npz] [--max-images 4]

Stages, each independent (a missing input reports "skipped"):

1. convert           — every family given, through ``seed_tpu_torch.convert``
                       (``python3 -m seed_tpu_torch.convert``'s paths).
2. tokenizer_parity  — the reference's own ``get_codebook_indices`` (the
                       reference tree imported through
                       ``tests/reference_shims.py``, torch on the CPU, fp32)
                       against the port's fp32 encode on the same corpus;
                       pass = bit-identical ids, or flips only where both
                       sides' two candidate codes are near-equidistant. It
                       reports "skipped", with the reason, when the
                       reference tree is absent. ``--golden-ids`` (ids
                       recorded from the reference) takes its place.
3. unclip_decode     — the fixed-seed DDIM decode (``--diffusion-steps``):
                       finite, in [0, 1], the same over two runs; PSNR
                       against ``--golden-pixels`` when given.
4. canonical_prompts — VQA, text-to-image and the multimodal edit through
                       ``SeedLlamaInterface``: a non-empty answer, and
                       ``force_image`` gives a well-formed 32-code block.

``--synthetic`` runs every stage on small seeded weights (the tokenizer
scaled down with ``query_len`` 32, ``TINY_LLAMA``, ``TINY_UNCLIP``), so the
plumbing is checked before real weights are at hand; there stage 4 checks
structure only. The report passes when no stage reads "FAIL" and at least
one reads "pass"; the exit code is 0 then, else 1. It runs on the card
(``--device cuda``, the default) and raises where there is none.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import time
import types

import numpy as np
import torch

from .. import NUM_IMG_TOKENS, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SHIMS = os.path.join(REPO, "tests", "reference_shims.py")


def _stage(report, name):
    rec = {"status": "skipped"}
    report["stages"][name] = rec
    return rec


def _fail(rec, e: Exception) -> None:
    rec.update(status="FAIL", error=f"{type(e).__name__}: {e}")


def _convert(family: str, src: str, device):
    from ..convert.__main__ import convert
    return convert(types.SimpleNamespace(family=family, src=src,
                                         device=device, pad_vocab=None))


def stage_convert(args, report, out_dir, device) -> dict:
    """Convert every family given; each lands under ``out_dir``."""
    from ..utils.checkpoint import save_checkpoint
    rec = _stage(report, "convert")
    done = {}
    try:
        for family, src, dst in (("quantizer", args.quantizer, "tokenizer"),
                                 ("llama", args.llama, "llm"),
                                 ("lora", args.lora, "lora"),
                                 ("unclip", args.unclip, "unclip")):
            if src:
                save_checkpoint(os.path.join(out_dir, dst),
                                _convert(family, src, device))
                done[family] = True
        rec.update(status="pass" if done else "skipped", families=done)
    except Exception as e:
        _fail(rec, e)
    return done


def load_corpus(args, image_size: int) -> np.ndarray:
    """Corpus images as uint8 [N, S, S, 3] through the reference's square
    BICUBIC resize (seed_llama_tokenizer.py:51); seeded noise images when
    there is no corpus."""
    if args.corpus:
        from PIL import Image
        files = sorted(
            f for f in os.listdir(args.corpus)
            if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")))
        imgs = []
        for f in files[:args.max_images]:
            img = Image.open(os.path.join(args.corpus, f)).convert("RGB")
            imgs.append(np.asarray(
                img.resize((image_size, image_size), Image.BICUBIC),
                np.uint8))
        if imgs:
            return np.stack(imgs)
    rng = np.random.RandomState(7)
    return rng.randint(0, 256, (args.max_images, image_size, image_size, 3),
                       dtype=np.uint8)


def _encode_fp32(params, raw: np.ndarray, cfg, device):
    """(ids, pre-VQ features) of the fp32 exact encode, as numpy."""
    from ..models import seed_tokenizer as ST
    from ..ops.preprocess import preprocess
    with torch.inference_mode():
        x = preprocess(torch.from_numpy(raw).to(device), cfg.vit.image_size,
                       dtype=torch.float32)
        ids = ST.encode(params, x, cfg).cpu().numpy()
        feats = ST.encode_features(params, x, cfg).float().cpu().numpy()
    return ids, feats, x


def load_shims():
    """tests/reference_shims.py as a module, found by its path."""
    spec = importlib.util.spec_from_file_location("reference_shims", SHIMS)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tie_flips(ours, theirs, feats_ours, feats_theirs, codebook):
    """(near-tie flips, hard mismatches) of two id arrays: a flip where
    either side's two candidate codes are within 5e-3 relative distance is
    fp32 accumulation-order noise, not a conversion fault."""
    ties = hard = 0
    for b, t in np.argwhere(ours != theirs):
        rels = []
        for z in (feats_ours, feats_theirs):
            d = ((z[b, t][None] - codebook) ** 2).sum(-1)
            lo, hi = sorted([d[ours[b, t]], d[theirs[b, t]]])
            rels.append((hi - lo) / max(hi, 1e-12))
        if min(rels) <= 5e-3:
            ties += 1
        else:
            hard += 1
    return ties, hard


def _torch_state_dict(path):
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd["model"]
    return {k: v.float() if v.is_floating_point() else v
            for k, v in sd.items()}


def stage_tokenizer_parity(args, report, tok_cfg, params, device) -> None:
    """The reference quantizer against the port's fp32 exact encode."""
    rec = _stage(report, "tokenizer_parity")
    if params is None and not args.synthetic:
        return
    try:
        shims = load_shims()
        if not os.path.isdir(shims.REFERENCE_MODELS):
            rec["reason"] = (f"the reference tree {shims.REFERENCE_MODELS} is "
                             "absent")
            return
        from ..convert import convert_quantizer
        ref = shims.build_reference_quantizer(
            tok_cfg, init_seed=0 if args.synthetic else None)
        if args.synthetic:
            # both sides on the oracle's own weights, through the converter
            sd = {k: v.detach() for k, v in ref.state_dict().items()}
            params = convert_quantizer(sd, device=device)
        else:
            missing, _ = ref.load_state_dict(
                _torch_state_dict(args.quantizer), strict=False)
            live = [k for k in missing if "position_ids" not in k]
            if live:
                raise KeyError(f"checkpoint missing live keys: {live[:8]} "
                               f"(+{max(0, len(live) - 8)})")
        raw = load_corpus(args, tok_cfg.vit.image_size)
        ours, z, x = _encode_fp32(params, raw, tok_cfg, device)
        t0 = time.time()
        theirs_t, tfeat = ref.get_codebook_indices(
            x.float().cpu().permute(0, 3, 1, 2).contiguous())
        theirs, tfeat = theirs_t.numpy(), tfeat.numpy()
        agree = float((ours == theirs).mean())
        feat_rel = float(np.abs(z - tfeat).max() / max(tfeat.std(), 1e-12))
        ties, hard = tie_flips(ours, theirs, z, tfeat,
                               params["vq"]["codebook"].float().cpu().numpy())
        rec.update(status="pass" if hard == 0 and feat_rel < 0.05 else "FAIL",
                   bit_exact=agree == 1.0, agreement=agree,
                   feature_rel_err=round(feat_rel, 6), near_tie_flips=ties,
                   hard_mismatches=hard, n_images=int(raw.shape[0]),
                   torch_seconds=round(time.time() - t0, 1))
    except Exception as e:
        _fail(rec, e)


def stage_golden_ids(args, report, tok_cfg, params, device) -> None:
    """Stage 2 against ids recorded from the reference (``--golden-ids``)."""
    rec = _stage(report, "tokenizer_parity")
    try:
        raw = load_corpus(args, tok_cfg.vit.image_size)
        ours, _, _ = _encode_fp32(params, raw, tok_cfg, device)
        want = np.load(args.golden_ids)["ids"][:raw.shape[0]]
        agree = float((ours == want).mean())
        rec.update(status="pass" if agree == 1.0 else "FAIL",
                   bit_exact=agree == 1.0, agreement=agree,
                   n_images=int(raw.shape[0]), source="golden_ids")
    except Exception as e:
        _fail(rec, e)


def stage_unclip(args, report, params, cfg, device) -> None:
    rec = _stage(report, "unclip_decode")
    if params is None:
        return
    try:
        from ..models.unclip import UnCLIPDecoder
        dec = UnCLIPDecoder(params, cfg,
                            num_inference_steps=args.diffusion_steps,
                            device=device)
        emb = np.random.RandomState(0).randn(
            1, cfg.image_embed_dim).astype(np.float32)
        imgs, imgs2 = dec.generate(emb), dec.generate(emb)
        same = bool(np.array_equal(imgs, imgs2))
        ok = bool(np.isfinite(imgs).all() and imgs.min() >= 0.0
                  and imgs.max() <= 1.0 and same)
        rec.update(status="pass" if ok else "FAIL", shape=list(imgs.shape),
                   deterministic=same)
        if args.golden_pixels:
            want = np.load(args.golden_pixels)["images"]
            mse = float(((imgs - want) ** 2).mean())
            psnr = float(10 * np.log10(1.0 / max(mse, 1e-12)))
            rec.update(golden_psnr_db=round(psnr, 2),
                       status="pass" if ok and psnr > 30.0 else "FAIL")
    except Exception as e:
        _fail(rec, e)


def stage_canonical_prompts(args, report, iface, image_uint8) -> None:
    """The three tasks of seed_llama_inference_8B.py:94-120, checked for
    structure."""
    rec = _stage(report, "canonical_prompts")
    if iface is None:
        return
    try:
        from ..ops.preprocess import preprocess
        from ..serving.engine import GenerationConfig
        gen = GenerationConfig(temperature=0.8, top_p=0.5, do_sample=True,
                               max_new_tokens=args.max_new_tokens)
        s_tok, e_tok, sep = "USER:", "ASSISTANT:", "\n"
        codes = iface.encode_image(preprocess(
            torch.from_numpy(image_uint8[None]).to(iface.device),
            image_uint8.shape[0]))[0]
        results = {}
        segs = iface.generate(
            [f"{s_tok} ", codes, f"What is this animal?{sep}{e_tok}"],
            gen, seed=0)
        answer = "".join(s.text for s in segs if s.kind == "text")
        results["vqa"] = {"answer": answer[:200],
                          "nonempty": bool(answer.strip()),
                          "segments": len(segs)}
        segs = iface.generate(
            [f"{s_tok} Can you generate an image of a dog on the green "
             f"grass?{sep}{e_tok}"], gen, seed=0, force_image=True)
        blocks = [s for s in segs if s.kind == "image"]
        well_formed = bool(blocks) and all(
            s.image_codes is not None and s.image_codes.size == NUM_IMG_TOKENS
            for s in blocks)
        results["t2i"] = {"image_blocks": len(blocks),
                          "well_formed": well_formed}
        segs = iface.generate(
            [f"{s_tok} ", codes,
             f"Can you make the cat wear sunglasses?{sep}{e_tok}"],
            gen, seed=0, force_image=True)
        results["mm_edit"] = {
            "image_blocks": sum(s.kind == "image" for s in segs)}
        # with real weights the semantic checks hold; a random model may end
        # at once or malform the block, so synthetic runs check structure
        ok = (well_formed and results["vqa"]["nonempty"]
              if not args.synthetic else results["vqa"]["segments"] >= 0)
        rec.update(status="pass" if ok else "FAIL", **results)
    except Exception as e:
        _fail(rec, e)


def synthetic_tokenizer_config():
    """TINY_TOKENIZER scaled to keep query_len 32, the reference's
    causal-query trigger (qformer_causual.py:814-816)."""
    from ..models import seed_tokenizer as ST
    from ..models.qformer import QFormerConfig
    from ..models.vit import ViTConfig
    return dataclasses.replace(
        ST.TINY_TOKENIZER,
        vit=ViTConfig(image_size=28, patch_size=14, dim=32, depth=3, heads=2,
                      mlp_dim=64),
        qformer=QFormerConfig(hidden=32, layers=3, heads=2, intermediate=64,
                              encoder_width=32, query_len=32),
        codebook_size=64, code_dim=8, decode_depth=2, decode_heads=2,
        image_embed_dim=16)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python3 -m seed_tpu_torch.scripts.acceptance",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--quantizer", default=None,
                    help="seed_quantizer.pt (torch)")
    ap.add_argument("--llama", default=None, help="HF LLaMA dir (merged)")
    ap.add_argument("--lora", default=None, help="PEFT adapter ckpt")
    ap.add_argument("--unclip", default=None,
                    help="diffusers stable-diffusion-2-1-unclip dir")
    ap.add_argument("--text-tokenizer", default=None)
    ap.add_argument("--corpus", default=None, help="directory of images")
    ap.add_argument("--golden-pixels", default=None,
                    help=".npz with 'images' from the reference pipeline")
    ap.add_argument("--golden-ids", default=None,
                    help=".npz with 'ids' [N,32] recorded from the reference "
                         "tokenizer on --corpus (in place of the in-process "
                         "torch oracle)")
    ap.add_argument("--max-images", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=64)
    ap.add_argument("--diffusion-steps", type=int, default=20)
    ap.add_argument("--synthetic", action="store_true",
                    help="dry-run every stage with small seeded weights")
    ap.add_argument("--out", default="acceptance_out")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(args) -> dict:
    """Every stage; returns the report (also written to
    ``<out>/acceptance.json``)."""
    from ..models import llama as M
    from ..models import seed_tokenizer as ST
    from ..models.unclip import SD21_UNCLIP, TINY_UNCLIP, init_unclip
    from ..serving import (ByteTextTokenizer, HFTextTokenizer, LlamaEngine,
                           SeedLlamaInterface)
    from ..utils.checkpoint import restore_checkpoint
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    report = {"synthetic": bool(args.synthetic), "stages": {}}

    done = stage_convert(args, report, args.out, device)
    if args.synthetic:
        tok_cfg, llm_cfg, unclip_cfg = (synthetic_tokenizer_config(),
                                        M.TINY_LLAMA, TINY_UNCLIP)
        gen = lambda seed: torch.Generator(device=device).manual_seed(seed)
        tok_params = ST.init_seed_tokenizer(gen(0), tok_cfg, torch.float32,
                                            device)
        llm_params = M.init_llama(gen(1), llm_cfg, torch.float32, device)
        unclip_params = init_unclip(gen(2), unclip_cfg, torch.float32, device)
    else:
        tok_cfg, llm_cfg, unclip_cfg = (ST.SEED_TOKENIZER, M.SEED_LLAMA_8B,
                                        SD21_UNCLIP)
        load = lambda family, sub: (
            restore_checkpoint(os.path.join(args.out, sub), device=device)
            if done.get(family) else None)
        tok_params = load("quantizer", "tokenizer")
        llm_params = load("llama", "llm")
        unclip_params = load("unclip", "unclip")

    if args.golden_ids and tok_params is not None:
        stage_golden_ids(args, report, tok_cfg, tok_params, device)
    elif args.synthetic or (args.quantizer and tok_params is not None):
        stage_tokenizer_parity(args, report, tok_cfg, tok_params, device)

    stage_unclip(args, report, unclip_params, unclip_cfg, device)

    iface = None
    if llm_params is not None and tok_params is not None:
        text_tok = (HFTextTokenizer(args.text_tokenizer)
                    if args.text_tokenizer else ByteTextTokenizer())
        engine = LlamaEngine(llm_params, llm_cfg,
                             max_len=min(512, llm_cfg.max_seq_len),
                             device=device)
        iface = SeedLlamaInterface(engine, tok_params, tok_cfg, text_tok,
                                   device=device)
    image = load_corpus(args, tok_cfg.vit.image_size)[0]
    stage_canonical_prompts(args, report, iface, image)

    statuses = [s["status"] for s in report["stages"].values()]
    report["pass"] = ("FAIL" not in statuses
                      and any(s == "pass" for s in statuses))
    path = os.path.join(args.out, "acceptance.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))
    print(f"report -> {path}")
    return report


def main(argv=None) -> None:
    report = run(parse_args(argv))
    sys.exit(0 if report["pass"] else 1)


if __name__ == "__main__":
    main()
