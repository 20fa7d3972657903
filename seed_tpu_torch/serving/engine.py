"""Autoregressive generation engine (counterpart of seed_tpu/serving/engine.py).

Left-padded batched prefill into a preallocated KV cache (bf16, fp8 or
int8), prompt-length buckets, an optional forced first token (force_boi),
then decode in chunks of ``chunk_steps`` tokens through ``M.decode_loop``:
sampling stays on the device and the host reads one [B, chunk] block of
tokens per chunk. Rows that hit eos keep decoding in lockstep, pinned to eos.
``num_beams > 1`` takes the beam search of ``M.beam_loop``. The token stream
matches seed_tpu's engine: the same buckets, the same chunk-granular stop at
the end of the cache, greedy and beam tokens equal.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..models import llama as M
from ..ops.sampling import sample


@dataclass
class GenerationConfig:
    # reference defaults: scripts/seed_llama_inference_8B.py:81-87
    max_new_tokens: int = 512
    temperature: float = 1.0
    top_p: float = 0.5
    top_k: int = 0
    do_sample: bool = True
    eos_token_id: int = 2
    forced_first_token: Optional[int] = None   # force_boi (flask :158-175)
    # beam search (the caption eval generates with num_beams=5); > 1 implies
    # deterministic decoding: do_sample/temperature/top_p are ignored
    num_beams: int = 1
    length_penalty: float = 1.0


class LlamaEngine:
    """Holds the params of one model on ``device`` (the card by default) and
    generates from batches of prompts."""

    def __init__(self, params, cfg: M.LlamaConfig, max_len: Optional[int] = None,
                 prompt_buckets: Sequence[int] = (32, 64, 128, 256, 512, 1024),
                 cache_dtype=torch.bfloat16, chunk_steps: int = 32,
                 device="cuda"):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        # a tree sharded over ``tensor`` caches each rank's own kv heads
        self.kv_heads = M.cache_kv_heads(params, cfg)
        self.max_len = max_len or cfg.max_seq_len
        self.buckets = sorted(b for b in prompt_buckets if b <= self.max_len)
        self.cache_dtype = cache_dtype
        # seed_tpu decodes chunk_steps tokens per dispatch and stops a chunk
        # early only at the end of the cache; the port keeps that stopping
        # rule so both engines emit the same number of tokens
        self.chunk_steps = chunk_steps

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_len

    def _prefill_prompts(self, prompt_ids: Sequence[Sequence[int]]):
        """Left-pad to the bucket (every row's last prompt token in the same
        column) and prefill a fresh cache. Returns (logits, cache, bucket)."""
        B = len(prompt_ids)
        lens = [len(p) for p in prompt_ids]
        bucket = self._bucket(max(lens))
        ids = np.zeros((B, bucket), np.int64)
        mask = np.zeros((B, bucket), np.int64)
        for i, p in enumerate(prompt_ids):
            ids[i, bucket - lens[i]:] = np.asarray(p, np.int64)
            mask[i, bucket - lens[i]:] = 1
        cache = M.init_cache(self.cfg, B, self.max_len, self.cache_dtype,
                             self.device, kv_heads=self.kv_heads)
        logits, cache = M.prefill(self.params,
                                  torch.from_numpy(ids).to(self.device), cache,
                                  self.cfg,
                                  chunk_mask=torch.from_numpy(mask).to(self.device))
        return logits, cache, bucket

    @torch.inference_mode()
    def generate(self, prompt_ids: Sequence[Sequence[int]],
                 gen: GenerationConfig = GenerationConfig(),
                 seed: int = 0) -> List[List[int]]:
        """Batch generate. Returns new tokens per sequence (without prompt)."""
        if gen.num_beams > 1:
            return self._beam_generate(prompt_ids, gen)
        B = len(prompt_ids)
        logits, cache, bucket = self._prefill_prompts(prompt_ids)
        rng = torch.Generator(device=self.device).manual_seed(seed)
        if gen.forced_first_token is not None:
            tok = torch.full((B,), gen.forced_first_token, dtype=torch.int64,
                             device=self.device)
        else:
            tok = sample(rng, logits[:, -1], gen.temperature, gen.top_p,
                         gen.top_k, gen.do_sample)
        tok_np = tok.cpu().numpy()
        out_tokens: List[List[int]] = [[int(t)] for t in tok_np]
        finished = tok_np == gen.eos_token_id

        # remaining tokens: chunks of chunk_steps, sampling + eos pinning on
        # the device; the host only unpacks [B, chunk] blocks
        budget = gen.max_new_tokens - 1
        index = bucket
        while budget > 0 and not finished.all():
            steps = min(self.chunk_steps, budget)
            if index + steps >= self.max_len:
                break   # cache full
            toks, done, cache, rng = M.decode_loop(
                self.params, tok, cache, rng, self.cfg, steps=steps,
                temperature=gen.temperature, top_p=gen.top_p, top_k=gen.top_k,
                do_sample=gen.do_sample, eos_id=gen.eos_token_id)
            toks_np = toks.cpu().numpy()                    # [B, steps]
            for i in range(B):
                if finished[i]:
                    continue
                row = toks_np[i]
                hits = np.nonzero(row == gen.eos_token_id)[0]
                end = int(hits[0]) + 1 if hits.size else steps
                out_tokens[i].extend(int(t) for t in row[:end])
                if hits.size:
                    finished[i] = True
            tok = toks[:, -1]
            finished |= done.cpu().numpy()
            budget -= steps
            index += steps
        # strip trailing eos
        for i in range(B):
            if out_tokens[i] and out_tokens[i][-1] == gen.eos_token_id:
                out_tokens[i] = out_tokens[i][:-1]
        return out_tokens

    @torch.inference_mode()
    def _beam_generate(self, prompt_ids: Sequence[Sequence[int]],
                       gen: GenerationConfig) -> List[List[int]]:
        """num_beams > 1: one prefill, K-fold cache expansion, then the whole
        search on the device (M.beam_loop). Returns the best beam's new
        tokens per sequence (eos stripped)."""
        B, K = len(prompt_ids), gen.num_beams
        logits, cache, bucket = self._prefill_prompts(prompt_ids)
        logp0 = torch.log_softmax(logits[:, -1].float(), dim=-1)
        if gen.forced_first_token is not None:
            # all beams share the forced token: only beam 0 is viable at
            # init, or the top-K would clone identical beams K times
            tok0 = torch.full((B, K), gen.forced_first_token,
                              dtype=torch.int64, device=self.device)
            scores0 = torch.full((B, K), M._BEAM_NEG, dtype=torch.float32,
                                 device=self.device)
            scores0[:, 0] = logp0[:, gen.forced_first_token]
        else:
            scores0, tok0 = torch.topk(logp0, K, dim=-1)
        rows = torch.arange(B, device=self.device).repeat_interleave(K)
        cache = M.gather_cache_rows(cache, rows)
        steps = max(0, min(gen.max_new_tokens - 1, self.max_len - bucket - 1))
        hist, norm, gen_len = M.beam_loop(
            self.params, tok0, scores0, cache, self.cfg, steps=steps,
            eos_id=gen.eos_token_id, length_penalty=gen.length_penalty)
        hist, norm, gen_len = (hist.cpu().numpy(), norm.cpu().numpy(),
                               gen_len.cpu().numpy())
        out: List[List[int]] = []
        for b in range(B):
            k = int(norm[b].argmax())
            toks = [int(t) for t in hist[b, k, :int(gen_len[b, k])]]
            if toks and toks[-1] == gen.eos_token_id:
                toks = toks[:-1]
            out.append(toks)
        return out
