"""Autoregressive generation engine (counterpart of seed_tpu/serving/engine.py).

Left-padded batched prefill into a preallocated KV cache, prompt-length
buckets, an optional forced first token (force_boi), then decode as a
Python loop over ``decode_step`` with sampling on the device. Rows that hit
eos keep decoding in lockstep, pinned to eos, until every row is done. The
token stream matches seed_tpu's engine: the same buckets, the same
chunk-granular stop at the end of the cache, greedy tokens equal.
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

    @torch.inference_mode()
    def generate(self, prompt_ids: Sequence[Sequence[int]],
                 gen: GenerationConfig = GenerationConfig(),
                 seed: int = 0) -> List[List[int]]:
        """Batch generate. Returns new tokens per sequence (without prompt)."""
        B = len(prompt_ids)
        lens = [len(p) for p in prompt_ids]
        bucket = self._bucket(max(lens))
        # left-pad so every row's last prompt token sits at the same column
        ids = np.zeros((B, bucket), np.int64)
        mask = np.zeros((B, bucket), np.int64)
        for i, p in enumerate(prompt_ids):
            ids[i, bucket - lens[i]:] = np.asarray(p, np.int64)
            mask[i, bucket - lens[i]:] = 1

        cache = M.init_cache(self.cfg, B, self.max_len, self.cache_dtype,
                             self.device)
        logits, cache = M.prefill(self.params,
                                  torch.from_numpy(ids).to(self.device), cache,
                                  self.cfg,
                                  chunk_mask=torch.from_numpy(mask).to(self.device))
        rng = torch.Generator(device=self.device).manual_seed(seed)
        if gen.forced_first_token is not None:
            tok = torch.full((B,), gen.forced_first_token, dtype=torch.int64,
                             device=self.device)
        else:
            tok = sample(rng, logits[:, -1], gen.temperature, gen.top_p,
                         gen.top_k, gen.do_sample)
        out_tokens: List[List[int]] = [[t] for t in tok.tolist()]
        finished = [t == gen.eos_token_id for t in tok.tolist()]
        done = tok == gen.eos_token_id

        budget = gen.max_new_tokens - 1
        index = bucket
        while budget > 0 and not all(finished):
            steps = min(self.chunk_steps, budget)
            if index + steps >= self.max_len:
                break   # cache full
            for _ in range(steps):
                logits, cache = M.decode_step(self.params, tok[:, None], cache,
                                              self.cfg)
                nxt = sample(rng, logits[:, 0], gen.temperature, gen.top_p,
                             gen.top_k, gen.do_sample)
                nxt = torch.where(done, torch.full_like(nxt, gen.eos_token_id),
                                  nxt)
                done = done | (nxt == gen.eos_token_id)
                tok = nxt
                for i, t in enumerate(nxt.tolist()):
                    if not finished[i]:
                        out_tokens[i].append(t)
                        finished[i] = t == gen.eos_token_id
                if all(finished):
                    break
            budget -= steps
            index += steps
        # strip trailing eos
        for i in range(B):
            if out_tokens[i] and out_tokens[i][-1] == gen.eos_token_id:
                out_tokens[i] = out_tokens[i][:-1]
        return out_tokens
