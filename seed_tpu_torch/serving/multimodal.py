"""Interleaved image+text generation — the SEED-LLaMA public API
(counterpart of seed_tpu/serving/multimodal.py).

Images are encoded to 32 VQ codes and spliced into the token stream as
``BOI, code+32000 ..., EOI``; prompts follow the Vicuna ``USER:/ASSISTANT:``
template; generated ids are split at BOI/EOI, image segments decoding to
the unCLIP image embedding through the SEED tokenizer's ``decode_embedding``.
Fusion happens in id space; the string adapters give the reference's
'<img><img_00042>...</img>' string space.

The unCLIP diffusion de-tokenizer (embedding -> pixels) and the host offload
of the tokenizer are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .. import (BOI_TOKEN, BOI_TOKEN_ID, EOI_TOKEN, EOI_TOKEN_ID, IMG_TOKEN,
                IMAGE_ID_SHIFT, NUM_IMG_CODES, NUM_IMG_TOKENS, resolve_device)
from ..models import seed_tokenizer as ST
from .engine import GenerationConfig, LlamaEngine


class ByteTextTokenizer:
    """Self-contained byte-level text tokenizer for tests and demos."""
    bos_token_id = 1
    eos_token_id = 2
    vocab_offset = 3

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids = [b + self.vocab_offset for b in text.encode("utf-8")]
        return ([self.bos_token_id] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        bs = bytes(i - self.vocab_offset for i in ids
                   if i >= self.vocab_offset and i < 259)
        return bs.decode("utf-8", errors="ignore")


@dataclass
class PromptTemplate:
    """Conversation template (gradio_demo/conversation.py SINGLE)."""
    s_token: str = "USER:"
    e_token: str = "ASSISTANT:"
    sep: str = "\n"

    def wrap(self, user_content_ids: List[int], tokenizer) -> List[int]:
        head = tokenizer.encode(self.s_token + " ")
        tail = tokenizer.encode(self.sep + self.e_token)
        return [tokenizer.bos_token_id] + head + user_content_ids + tail


def image_ids_to_tokens(codes: Sequence[int]) -> List[int]:
    """32 VQ codes -> [BOI, code+shift..., EOI] id segment."""
    return ([BOI_TOKEN_ID] + [int(c) + IMAGE_ID_SHIFT for c in codes]
            + [EOI_TOKEN_ID])


# ------------------------ string-space adapter ------------------------------

_IMG_CODE_RE = re.compile(r"<img_(\d{5})>")
_IMG_BLOCK_RE = re.compile(re.escape(BOI_TOKEN) + r"((?:<img_\d{5}>)*)"
                           + re.escape(EOI_TOKEN))


def codes_to_string(codes: Sequence[int]) -> str:
    """VQ codes [32] -> '<img><img_xxxxx>...</img>' (IMG_TOKEN format)."""
    codes = np.asarray(codes).reshape(-1)
    if not ((0 <= codes) & (codes < NUM_IMG_CODES)).all():
        raise ValueError(f"image codes out of range [0, {NUM_IMG_CODES})")
    return (BOI_TOKEN + "".join(IMG_TOKEN.format(int(c)) for c in codes)
            + EOI_TOKEN)


def string_to_parts(text: str) -> List[Union[str, np.ndarray]]:
    """Split a string containing '<img>...</img>' blocks into interleaved
    [str | codes ndarray] parts for build_prompt()."""
    parts: List[Union[str, np.ndarray]] = []
    pos = 0
    for m in _IMG_BLOCK_RE.finditer(text):
        if m.start() > pos:
            parts.append(text[pos:m.start()])
        parts.append(np.asarray([int(c) for c in _IMG_CODE_RE.findall(m.group(1))],
                                np.int32))
        pos = m.end()
    if pos < len(text):
        parts.append(text[pos:])
    return parts


def segments_to_string(segments: Sequence["Segment"]) -> str:
    """Render generate() output back to the reference's string space."""
    return "".join((seg.text or "") if seg.kind == "text"
                   else codes_to_string(seg.image_codes) for seg in segments)


@dataclass
class Segment:
    kind: str                      # "text" | "image"
    text: Optional[str] = None
    image_codes: Optional[np.ndarray] = None
    image_embedding: Optional[np.ndarray] = None   # unCLIP embedding


class SeedLlamaInterface:
    """Tokenizer + LLM bundled behind one generate() call (LLMService of
    gradio_demo/seed_llama_flask.py:61-230). ``tok_params`` live on
    ``device`` (the card by default)."""

    def __init__(self, engine: Optional[LlamaEngine], tok_params=None,
                 tok_cfg: ST.SeedTokenizerConfig = ST.SEED_TOKENIZER,
                 text_tokenizer=None, device="cuda"):
        self.device = resolve_device(device)
        self.engine = engine
        self.tok_params = tok_params
        self.tok_cfg = tok_cfg
        self.text = text_tokenizer or ByteTextTokenizer()

    # ---- image <-> ids ----
    @torch.inference_mode()
    def encode_image(self, images: torch.Tensor) -> np.ndarray:
        """preprocessed images [B,H,W,3] -> codes [B, 32]."""
        images = images.to(self.device)
        return ST.encode(self.tok_params, images, self.tok_cfg).cpu().numpy()

    @torch.inference_mode()
    def decode_image(self, codes: np.ndarray) -> np.ndarray:
        """codes [B, 32] -> unCLIP image embeddings [B, image_embed_dim]."""
        ids = torch.as_tensor(np.asarray(codes), device=self.device)
        emb = ST.decode_embedding(self.tok_params, ids, self.tok_cfg)
        return emb.float().cpu().numpy()

    # ---- prompt assembly ----
    def build_prompt(self, parts: Sequence[Union[str, np.ndarray]],
                     template: Optional[PromptTemplate] = PromptTemplate()
                     ) -> List[int]:
        """parts: strings and/or code arrays [32] -> full prompt ids."""
        content: List[int] = []
        for part in parts:
            if isinstance(part, str):
                content.extend(self.text.encode(part))
            else:
                content.extend(image_ids_to_tokens(np.asarray(part).reshape(-1)))
        if template is None:
            return [self.text.bos_token_id] + content
        return template.wrap(content, self.text)

    # ---- generation + splitting ----
    def generate(self, parts: Sequence[Union[str, np.ndarray]],
                 gen: Optional[GenerationConfig] = None, seed: int = 0,
                 force_image: bool = False) -> List[Segment]:
        gen = gen or GenerationConfig(eos_token_id=self.text.eos_token_id)
        if force_image:
            gen = dataclasses.replace(gen, forced_first_token=BOI_TOKEN_ID)
        prompt = self.build_prompt(parts)
        out = self.engine.generate([prompt], gen, seed=seed)[0]
        return self.split_output(out)

    def generate_from_string(self, text: str,
                             gen: Optional[GenerationConfig] = None,
                             seed: int = 0, force_image: bool = False) -> str:
        """String-space API: prompt with '<img><img_xxxxx>...</img>' blocks
        in, generated string (same vocabulary) out."""
        segs = self.generate(string_to_parts(text), gen, seed, force_image)
        return segments_to_string(segs)

    def split_output(self, ids: Sequence[int]) -> List[Segment]:
        """Split generated ids at BOI/EOI boundaries, with the flask server's
        pairing validation: a malformed image block surfaces as text."""
        segments: List[Segment] = []
        ids = list(ids)
        i = 0
        text_acc: List[int] = []

        def flush_text():
            if text_acc:
                segments.append(Segment("text", text=self.text.decode(text_acc)))
                text_acc.clear()

        while i < len(ids):
            if ids[i] == BOI_TOKEN_ID:
                j = i + 1
                codes = []
                while j < len(ids) and ids[j] != EOI_TOKEN_ID:
                    codes.append(ids[j] - IMAGE_ID_SHIFT)
                    j += 1
                valid = (j < len(ids) and len(codes) == NUM_IMG_TOKENS
                         and all(0 <= c < NUM_IMG_CODES for c in codes))
                if valid:
                    flush_text()
                    codes = np.asarray(codes, np.int32)[None]
                    seg = Segment("image", image_codes=codes)
                    if self.tok_params is not None:
                        seg.image_embedding = self.decode_image(codes)
                    segments.append(seg)
                    i = j + 1
                else:
                    text_acc.append(ids[i])
                    i += 1
            else:
                text_acc.append(ids[i])
                i += 1
        flush_text()
        return segments
