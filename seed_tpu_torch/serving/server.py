"""HTTP serving: the /generate JSON contract of the reference Flask backend
(counterpart of seed_tpu/serving/server.py and scripts/serve.py).

Re-implements gradio_demo/seed_llama_flask.py:93-226 on the stdlib
http.server (no Flask dependency):

request  {"text": "... <image> ...", "images": [base64 | [32 ids]],
          "temperature": 0.7, "max_new_tokens": 256, "top_p": 0.5,
          "force_boi": false}
response {"text": "... <image> ...", "images": [base64 png],
          "images_ids": [[...]], "error_msg": [...]}

Semantics preserved: text splits at IMG_FLAG (one image per flag), mixed
base64/cached-ids inputs are encoded in one batch, BOI/EOI pairing is
validated with error accumulation instead of crashing (:186-203), and
generated image spans are replaced by IMG_FLAG in the returned text. A
generated image comes back as its ids in ``images_ids`` and, with the unCLIP
de-tokenizer attached (``--diffusion-ckpt``), as a base64 PNG in ``images``;
without one, as an empty string there.

    python -m seed_tpu_torch.serving.server --model 8b --scheduler \
        --slot-cache fp8 --w8a8-encoder

starts the service on the card with seeded random weights (or checkpoints
given with --llm-ckpt / --tokenizer-ckpt; --diffusion-ckpt takes an unCLIP
checkpoint written by ``python3 -m seed_tpu_torch.convert unclip``).
"""
from __future__ import annotations

import base64
import io
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import (BOI_TOKEN_ID, EOI_TOKEN_ID, IMAGE_ID_SHIFT, IMG_FLAG,
                NUM_IMG_CODES, NUM_IMG_TOKENS)
from .engine import GenerationConfig
from .multimodal import SeedLlamaInterface, image_ids_to_tokens
from .scheduler import ScheduledEngine


def decode_image_b64(b64: str):
    from PIL import Image
    return Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB")


def encode_image_b64(arr: np.ndarray) -> str:
    """float [H,W,3] in [0,1] or uint8 -> base64 PNG."""
    from PIL import Image
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


class GenerateService:
    """Framework-agnostic request handler (unit-testable without sockets)."""

    def __init__(self, iface: SeedLlamaInterface, image_size: int = 224,
                 keep_ratio: bool = False):
        """``keep_ratio`` selects the reference transform branch
        (models/transforms.py:4-21): False (default) = square resize —
        the demo's SHIPPED config (configs/transform/clip_transform.yaml
        keep_ratio: False) AND the tokenizer's own processor
        (seed_llama_tokenizer.py:51, BICUBIC); True = Resize(short side,
        BILINEAR) + CenterCrop, the get_transform signature default."""
        self.iface = iface
        self.image_size = image_size
        self.keep_ratio = keep_ratio
        # a LlamaEngine serves one generate call at a time; a
        # ScheduledEngine batches concurrent callers itself
        self._lock = threading.Lock()

    def _prepare_image(self, img) -> np.ndarray:
        """PIL image -> uint8 [S, S, 3] with the reference's exact
        transform numerics. Host-side PIL resampling: PIL *is* the
        reference numerics (torchvision dispatches to it for PIL input),
        and serving uploads arrive one at a time in arbitrary sizes.
        Batched uniform-size pipelines should use the device ops
        (preprocess / center_crop_resize_pil) instead."""
        from PIL import Image
        from ..ops.preprocess import (torchvision_crop_box,
                                      torchvision_resize_size)
        S = self.image_size
        if not self.keep_ratio:
            # transforms.Resize((S, S), interpolation=3) — square BICUBIC
            return np.asarray(img.resize((S, S), Image.BICUBIC), np.uint8)
        # transforms.Resize(S) (BILINEAR default) + CenterCrop(S)
        w, h = img.size
        new_h, new_w = torchvision_resize_size(h, w, S)
        if (new_h, new_w) != (h, w):
            img = img.resize((new_w, new_h), Image.BILINEAR)
        arr = np.asarray(img, np.uint8)
        if arr.shape[:2] != (S, S):
            top, left = torchvision_crop_box(new_h, new_w, S)
            arr = arr[top:top + S, left:left + S]
        return arr

    def _encode_images(self, image_list: List[Any]) -> List[List[int]]:
        """Mixed base64 / cached-ids inputs -> per-image 32 codes
        (seed_llama_flask.py:108-142, batched encode for the pixel ones)."""
        from ..ops.preprocess import preprocess
        pixel_idx, pixel_imgs, out = [], [], [None] * len(image_list)
        for i, item in enumerate(image_list):
            if isinstance(item, str):
                img = decode_image_b64(item)
                pixel_idx.append(i)
                pixel_imgs.append(self._prepare_image(img))
            else:
                out[i] = [int(x) for x in item]
        if pixel_imgs:
            raw = torch.from_numpy(np.stack(pixel_imgs)).to(self.iface.device)
            # pixels in the type of the encoder's weights (bf16 in serving)
            dtype = self.iface.tok_params["vit"]["patch_embed"]["kernel"].dtype
            codes = self.iface.encode_image(
                preprocess(raw, self.image_size, dtype))
            for j, i in enumerate(pixel_idx):
                out[i] = [int(x) for x in codes[j]]
        return out

    def generate(self, req: Dict[str, Any]) -> Dict[str, Any]:
        text_list = req["text"].split(IMG_FLAG)
        image_list = req.get("images", [])
        if len(text_list) != len(image_list) + 1:
            return {"text": "", "images": [], "images_ids": [],
                    "error_msg": [f"text has {len(text_list) - 1} {IMG_FLAG} "
                                  f"placeholders but {len(image_list)} images"]}

        error_msg: List[str] = []
        images_ids_list = self._encode_images(image_list) if image_list else []

        # assemble prompt ids (id-space; string fusion not needed)
        tok = self.iface.text
        prompt: List[int] = [tok.bos_token_id]
        for i, codes in enumerate(images_ids_list):
            prompt += tok.encode(text_list[i])
            prompt += image_ids_to_tokens(codes)
        prompt += tok.encode(text_list[-1])
        force_boi = bool(req.get("force_boi", False))

        gen = GenerationConfig(
            temperature=float(req.get("temperature", 0.7)),
            max_new_tokens=int(req.get("max_new_tokens", 256)),
            top_p=float(req.get("top_p", 0.5)),
            do_sample=True,
            eos_token_id=tok.eos_token_id,
            forced_first_token=BOI_TOKEN_ID if force_boi else None,
        )
        if isinstance(self.iface.engine, ScheduledEngine):
            out_ids = self.iface.engine.generate([prompt], gen)[0]
        else:
            with self._lock:
                out_ids = self.iface.engine.generate([prompt], gen)[0]

        # split generated ids: images decoded, text spans re-joined
        # (validation semantics of :186-203)
        boi = [i for i, t in enumerate(out_ids) if t == BOI_TOKEN_ID]
        eoi = [i for i, t in enumerate(out_ids) if t == EOI_TOKEN_ID]
        if len(boi) != len(eoi):
            error_msg.append(
                f"Num of BOI tokens: {len(boi)} != EOI tokens: {len(eoi)}; "
                "some images will fail to decode.")
        generated_images: List[str] = []
        for b, e in zip(boi, eoi):
            codes = [t - IMAGE_ID_SHIFT for t in out_ids[b + 1:e]]
            img_b64 = ""
            if len(codes) != NUM_IMG_TOKENS:
                error_msg.append(
                    f"len(image_ids) {len(codes)} != {NUM_IMG_TOKENS}")
            elif any(c < 0 or c >= NUM_IMG_CODES for c in codes):
                error_msg.append(
                    f"some image_id out of range [0, {NUM_IMG_CODES})")
            else:
                arr = np.asarray(codes, np.int32)[None]
                decoded = self.iface.decode_image(arr)
                if self.iface.diffusion is not None:
                    img_b64 = encode_image_b64(decoded[0])
                images_ids_list.append(codes)
            generated_images.append(img_b64)

        # re-insert IMG_FLAG at image positions in reading order
        spans: List[str] = []
        last = 0
        for b, e in zip(boi, eoi):
            spans.append(self.iface.text.decode(out_ids[last:b]))
            spans.append(IMG_FLAG)
            last = e + 1
        spans.append(self.iface.text.decode(out_ids[last:]))
        text = "".join(spans)

        return {"text": text, "images": generated_images,
                "images_ids": [list(map(int, ids)) for ids in images_ids_list],
                "error_msg": error_msg}


def vote_log_path(log_dir: str) -> str:
    """Daily conversation/vote log file (gradio_demo get_conv_log_filename
    semantics: one JSON-lines file per UTC day)."""
    import datetime
    name = datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%d-conv.json")
    return os.path.join(log_dir, name)


def record_vote(log_dir: str, vote_type: str, state, ip: str = "") -> None:
    """Append one vote record (gradio_demo/seed_llama_gradio.py:139-148)."""
    os.makedirs(log_dir, exist_ok=True)
    data = {"tstamp": round(time.time(), 4), "type": vote_type,
            "state": state, "ip": ip}
    with open(vote_log_path(log_dir), "a") as f:
        f.write(json.dumps(data) + "\n")


def make_server(service: GenerateService, host: str = "0.0.0.0",
                port: int = 7890,
                log_dir: Optional[str] = None) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path in ("/", "/index.html"):
                from .webui import PAGE
                body = PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_error(404)

        def do_POST(self):
            path = self.path.rstrip("/")
            if path == "/vote":
                length = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(length))
                    record_vote(log_dir or "serving_logs",
                                str(req.get("type", "common")),
                                req.get("state"),
                                ip=self.client_address[0])
                    body = json.dumps({"ok": True}).encode()
                    self.send_response(200)
                except Exception as e:
                    body = json.dumps({"ok": False,
                                       "error_msg": [repr(e)]}).encode()
                    self.send_response(500)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if path != "/generate":
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(length))
                resp = service.generate(req)
                body = json.dumps(resp).encode()
                self.send_response(200)
            except Exception as e:  # error accumulation, not crashes
                body = json.dumps({"text": "", "images": [],
                                   "images_ids": [],
                                   "error_msg": [repr(e)]}).encode()
                self.send_response(500)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            pass

    return ThreadingHTTPServer((host, port), Handler)


def serve(service: GenerateService, host: str = "0.0.0.0", port: int = 7890):
    server = make_server(service, host, port)
    print(f"seed_tpu_torch serving on http://{host}:{port}/generate",
          flush=True)
    server.serve_forever()


def build_service(args) -> GenerateService:
    """The service ``main`` serves: models from checkpoints or seeded random
    weights on ``args.device``, the LLM int8 under DEFAULT_TARGETS at 8b/14b,
    behind a LlamaEngine or (``--scheduler``) a ScheduledEngine; with
    ``--diffusion-ckpt`` the SD2.1 unCLIP de-tokenizer decodes generated
    images to pixels (in host memory between calls under ``--offload``)."""
    from ..models import llama as M
    from ..models import seed_tokenizer as ST
    from ..ops.quantization import DEFAULT_TARGETS
    from ..utils.checkpoint import restore_checkpoint
    from .engine import LlamaEngine
    from .multimodal import ByteTextTokenizer, HFTextTokenizer

    device = args.device
    cfg = {"8b": M.SEED_LLAMA_8B, "14b": M.SEED_LLAMA_14B,
           "tiny": M.LlamaConfig(vocab_size=40194, dim=256, layers=2, heads=4,
                                 kv_heads=4, ffn_dim=512, max_seq_len=1024)
           }[args.model]
    tok_cfg = ST.SEED_TOKENIZER
    if args.llm_ckpt:
        llm = restore_checkpoint(args.llm_ckpt, device=device)
    else:
        llm = M.init_llama(
            torch.Generator(device=device).manual_seed(0), cfg, torch.bfloat16,
            device, None if args.model == "tiny" else DEFAULT_TARGETS)
    if args.tokenizer_ckpt:
        tok_params = restore_checkpoint(args.tokenizer_ckpt, device=device)
    else:
        tok_params = ST.init_seed_tokenizer(
            torch.Generator(device=device).manual_seed(1), tok_cfg,
            torch.bfloat16, device)
    if args.w8a8_encoder:
        tok_params, tok_cfg = ST.quantize_for_serving(tok_params, tok_cfg)
        tok_cfg = ST.serving_fast_config(tok_cfg)
    text_tok = (HFTextTokenizer(args.text_tokenizer) if args.text_tokenizer
                else ByteTextTokenizer())
    if args.scheduler:
        engine = ScheduledEngine(
            llm, cfg, slots=args.slots, decode_chunk=args.decode_chunk,
            cache_dtype={"bf16": torch.bfloat16,
                         "fp8": torch.float8_e4m3fn}[args.slot_cache],
            device=device)
    else:
        engine = LlamaEngine(llm, cfg, device=device)
    diffusion = None
    if args.diffusion_ckpt:
        from ..models.unclip import SD21_UNCLIP, UnCLIPDecoder
        diffusion = UnCLIPDecoder(
            restore_checkpoint(args.diffusion_ckpt,
                               device="cpu" if args.offload else device),
            SD21_UNCLIP, offload=args.offload, device=device)
    iface = SeedLlamaInterface(engine, tok_params, tok_cfg, text_tok,
                               diffusion=diffusion, offload=args.offload,
                               device=device)
    return GenerateService(iface, keep_ratio=args.keep_ratio)


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(
        description="SEED-LLaMA HTTP service on one NVIDIA GPU")
    ap.add_argument("--model", choices=["8b", "14b", "tiny"], default="tiny")
    ap.add_argument("--llm-ckpt", default=None)
    ap.add_argument("--tokenizer-ckpt", default=None)
    ap.add_argument("--diffusion-ckpt", default=None,
                    help="unCLIP checkpoint (python3 -m seed_tpu_torch.convert "
                         "unclip): generated images come back as PNGs")
    ap.add_argument("--text-tokenizer", default=None)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=7890)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--keep-ratio", action="store_true",
                    help="Resize(short side)+CenterCrop instead of the square "
                         "resize (the get_transform keep_ratio branch; the "
                         "shipped demo config uses keep_ratio=False)")
    ap.add_argument("--offload", action="store_true",
                    help="keep the tokenizer's and the de-tokenizer's params "
                         "in pinned host memory and swap them onto the "
                         "device per call")
    ap.add_argument("--scheduler", action="store_true",
                    help="serve the LLM through the continuous-batching "
                         "scheduler: concurrent requests share decode steps "
                         "(slots/decode-chunk below) instead of serializing "
                         "whole generate calls")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--decode-chunk", type=int, default=8)
    ap.add_argument("--slot-cache", choices=("bf16", "fp8"), default="bf16",
                    help="slot KV cache type: fp8 (e4m3) halves its bytes")
    ap.add_argument("--w8a8-encoder", action="store_true",
                    help="int8 x int8 ViT block matmuls through the w8a8 "
                         "kernel (quantize_for_serving + serving_fast_config)")
    args = ap.parse_args(argv)
    serve(build_service(args), host=args.host, port=args.port)


if __name__ == "__main__":
    main()
