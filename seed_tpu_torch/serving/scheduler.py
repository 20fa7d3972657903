"""Continuous batching scheduler (counterpart of
seed_tpu/serving/scheduler.py).

The throughput serving mode: a fixed pool of decode slots runs in lockstep;
finished requests free their slot immediately and queued requests are
prefilled into free slots between decode steps, with no waiting for the
whole batch to drain.

Prompts are padded to a few bucket lengths, so the slot programs see few
distinct shapes. Slot state lives on the device in the SlotCache, which the
programs update in place; the scheduler only moves token ids.
"""
from __future__ import annotations

import collections
import functools
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models import llama as M
from ..ops.sampling import fold_in, sample_batched
from .engine import GenerationConfig

_ZERO_KEY = np.zeros(2, np.uint32)


@dataclass
class Request:
    request_id: int
    prompt: List[int]
    gen: GenerationConfig
    # per-request key (two 32-bit words): token t samples with
    # fold_in(key, t), so the stream depends only on this request and is
    # reproducible under any concurrent slot mix
    key: np.ndarray = field(default_factory=lambda: _ZERO_KEY.copy())
    tokens: List[int] = field(default_factory=list)
    done: bool = False
    # wall-clock accounting (perf_counter): TTFT = t_first - t_submit,
    # end-to-end latency = t_done - t_submit
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


class ContinuousBatcher:
    def __init__(self, params, cfg: M.LlamaConfig, slots: int = 8,
                 max_len: Optional[int] = None,
                 prompt_buckets: Sequence[int] = (32, 64, 128, 256, 512),
                 cache_dtype=torch.bfloat16, seed: int = 0,
                 decode_chunk: int = 1, device="cuda"):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.slots = slots
        # >1 = multi-step scheduling: this many decode+sample steps per call
        # of M.slot_decode_sample_steps, one token transfer for all of them,
        # truncated host-side; admits happen only between chunks.
        self.decode_chunk = decode_chunk
        self.max_len = max_len or cfg.max_seq_len
        self.buckets = sorted(b for b in prompt_buckets if b < self.max_len)
        self.cache = M.init_slot_cache(cfg, slots, self.max_len, cache_dtype,
                                       self.device)
        self._prefill = functools.partial(M.slot_prefill, cfg=cfg)
        self._prefill_at = functools.partial(M.slot_prefill_at, cfg=cfg)
        # prefix install folded into the first prefill chunk of a hit
        self._install_prefill = functools.partial(M.install_and_prefill_at,
                                                  cfg=cfg)
        # prefix cache: token tuple -> (k, v) [L, H_kv, P, D] on the device
        # (shared-system-prompt reuse; longest match wins)
        self.prefixes: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._decode = functools.partial(M.slot_decode, cfg=cfg)
        # decode + per-slot sampling on the device: ONE [slots] token
        # transfer per step
        self._decode_sample = functools.partial(M.slot_decode_sample, cfg=cfg)
        self._decode_sample_steps = functools.partial(
            M.slot_decode_sample_steps, cfg=cfg)
        self._seed = np.uint32(seed)
        self.queue: collections.deque = collections.deque()
        self.active: List[Optional[Request]] = [None] * slots
        # which registered prefix a slot's cache positions [0, len) hold.
        # Decode and start>0 prefills never touch [0, len), so a slot
        # re-admitted with the SAME prefix skips the install dispatch —
        # through a remote PJRT link one dispatch (~36 ms) outweighs the
        # whole prefill of a short system prompt (PERF.md round 4).
        self.slot_prefix: List[Optional[tuple]] = [None] * slots
        self.next_tok = np.zeros(slots, np.int64)
        self._id_counter = itertools.count()
        self.finished: Dict[int, Request] = {}

    # ------------------------------ API ------------------------------------

    def submit(self, prompt: Sequence[int],
               gen: Optional[GenerationConfig] = None,
               key: Optional[np.ndarray] = None) -> int:
        """``key`` (uint32[2]) seeds this request's private sampling
        stream; default derives one from (batcher seed, request id)."""
        if len(prompt) >= self.max_len:
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds max_len="
                f"{self.max_len} (no room to generate)")
        gen = gen or GenerationConfig()
        rid = next(self._id_counter)
        if key is None:
            key = np.array([self._seed, rid], np.uint32)
        req = Request(rid, list(prompt), gen, key=np.asarray(key, np.uint32))
        req.t_submit = time.perf_counter()
        self.queue.append(req)
        return rid

    def register_prefix(self, prefix: Sequence[int]) -> None:
        """Precompute + pin the KV for a shared prompt prefix (system
        prompt). Future submits whose prompt starts with it skip its
        prefill work: the KV is block-copied into the slot and only the
        remainder runs through the model. Prefixes longer than the
        largest prompt bucket are prefilled in multiple chunks."""
        prefix = tuple(prefix)
        if prefix in self.prefixes or not prefix:
            return
        n = len(prefix)
        if n >= self.max_len:
            raise ValueError(
                f"prefix of {n} tokens exceeds max_len={self.max_len}")
        scratch = M.init_slot_cache(self.cfg, 1, self.max_len,
                                    self.cache.k.dtype, self.device)
        _, scratch, _ = self._chunked_prefill(list(prefix), 0, 0, scratch)
        # pin (k, v) [L, H_kv, P, D] on the device, in the cache's type
        self.prefixes[prefix] = (scratch.k[:, 0, :, :n].clone(),
                                 scratch.v[:, 0, :, :n].clone())

    def _match_prefix(self, prompt: List[int]):
        """Longest registered prefix that is a strict prefix of prompt."""
        best = None
        for pref in self.prefixes:
            p = len(pref)
            if (p < len(prompt) and (best is None or p > best)
                    and tuple(prompt[:p]) == pref):
                best = p
        return (best, self.prefixes[tuple(prompt[:best])]) \
            if best is not None else None

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.active)

    @torch.inference_mode()
    def run(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        """Drain all submitted requests; returns {request_id: tokens}."""
        for _ in range(max_steps):
            if not self.has_work():
                break
            self.step()
        return {rid: r.tokens for rid, r in self.finished.items()}

    # ----------------------------- internals --------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _chunked_prefill(self, tokens: List[int], slot: int, start: int,
                         cache, install_kv=None):
        """Prefill ``tokens[start:]`` into ``slot`` in bucket-sized chunks
        (positions [0, start) must already hold cached KV — the prefix-hit
        path). Prompts longer than the largest bucket take multiple
        dispatches; a chunk whose bucket would overrun the cache end
        SLIDES BACK so it ends exactly at max_len, re-listing (and
        recomputing) the overlapping already-cached tokens instead of
        writing past the end of the slot's row.

        Returns (last-token logits [1, V], cache, clobbered_prefix): the
        flag is True when a slide-back rewrote positions below ``start``
        — the recomputed values are equivalent but not guaranteed
        bit-identical to an installed prefix's pinned KV (different chunk
        boundaries under a lossy cache dtype), so the caller must drop
        the slot's prefix-identity tag and re-install on the next hit."""
        S = self.max_len
        n_total = len(tokens)
        pos = start
        logits = None
        clobbered = False
        while pos < n_total:
            n = min(n_total - pos, self.buckets[-1])
            bucket = self._bucket(n)
            chunk_start = pos
            if chunk_start + bucket > S:
                chunk_start = S - bucket      # slide back; overlap recomputed
            clobbered = clobbered or chunk_start < start
            n_eff = pos + n - chunk_start     # real tokens incl. overlap
            ids = np.zeros((1, bucket), np.int64)
            ids[0, :n_eff] = tokens[chunk_start:pos + n]
            ids = torch.from_numpy(ids).to(self.device)
            if chunk_start == 0:
                logits, cache = self._prefill(self.params, ids, n_eff, slot,
                                              cache)
            elif install_kv is not None:
                # prefix-hit admit: block-copy the pinned prefix KV and
                # run this chunk in the same call
                logits, cache = self._install_prefill(
                    self.params, install_kv, ids, n_eff, slot, chunk_start,
                    cache)
                install_kv = None
            else:
                logits, cache = self._prefill_at(self.params, ids, n_eff,
                                                 slot, chunk_start, cache)
            pos += n
        return logits, cache, clobbered

    def _admit(self):
        """Prefill queued requests into free slots."""
        for slot in range(self.slots):
            if self.active[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            hit = self._match_prefix(req.prompt)
            install_kv = None
            if hit is not None:
                start, pkv = hit
                pref = tuple(req.prompt[:start])
                if self.slot_prefix[slot] != pref:
                    install_kv = pkv   # folded into the first prefill chunk
                    self.slot_prefix[slot] = pref
            else:
                start = 0
                # a from-0 prefill overwrites [0, plen): the slot no
                # longer holds any registered prefix
                self.slot_prefix[slot] = None
            logits, self.cache, clobbered = self._chunked_prefill(
                req.prompt, slot, start, self.cache, install_kv)
            if clobbered:
                # a slide-back chunk rewrote positions inside the prefix
                # region: the rows are no longer the pinned install
                self.slot_prefix[slot] = None
            tok = self._pick(logits, req, first=True)
            self.active[slot] = req
            self.next_tok[slot] = tok
            req.tokens.append(int(tok))
            req.t_first = time.perf_counter()
            self._maybe_finish(slot)

    def _pick(self, logits, req: Request, first: bool = False) -> int:
        g = req.gen
        if first and g.forced_first_token is not None:
            return g.forced_first_token
        # the same per-request fold_in(key, ctr) stream as the batched
        # decode programs, on one row
        dev = self.device
        key = torch.from_numpy(req.key.astype(np.int64))[None].to(dev)
        ctr = torch.tensor([len(req.tokens)], device=dev)
        greedy = (not g.do_sample) or g.temperature == 0.0
        tok = sample_batched(
            fold_in(key, ctr), logits,
            torch.tensor([g.temperature], dtype=torch.float32, device=dev),
            torch.tensor([g.top_p], dtype=torch.float32, device=dev),
            torch.tensor([greedy], device=dev), g.top_k)
        return int(tok[0])

    def _maybe_finish(self, slot: int):
        req = self.active[slot]
        if req is None:
            return
        hit_eos = req.tokens and req.tokens[-1] == req.gen.eos_token_id
        full = (len(req.tokens) >= req.gen.max_new_tokens
                or len(req.prompt) + len(req.tokens) >= self.max_len - 1)
        if hit_eos or full:
            if hit_eos:
                req.tokens.pop()
            req.done = True
            req.t_done = time.perf_counter()
            self.finished[req.request_id] = req
            self.active[slot] = None   # slot freed for the next admit

    def _chunk_budget(self) -> int:
        """Steps the whole pool can decode in ONE chunk without any
        active slot overrunning the cache end: the only HARD bound.

        Token budgets and eos do NOT cap the chunk: a slot finishing
        mid-chunk has its tail discarded host-side (harmless by
        construction, slot_decode_sample_steps docstring), and admits
        can only happen between chunks anyway, so over-decoding a
        finished slot costs nothing the freed slot could have used.
        Capping by the pool's smallest remaining budget would collapse
        k_eff to 1-2 whenever any one slot is nearly done, which with many
        slots is almost every chunk."""
        rem = [(self.max_len - 1) - (len(r.prompt) + len(r.tokens))
               for r in self.active if r is not None]
        return max(1, min(rem)) if rem else 1

    @torch.inference_mode()
    def step(self):
        self._admit()
        active_mask = np.asarray([r is not None for r in self.active])
        if not active_mask.any():
            return
        ids = self.next_tok.copy().reshape(self.slots, 1)
        # per-slot sampling params ride the batch; top_k is shared by the
        # rows of one call, so mixed top_k falls back to the slot-wise host
        # path (rare; the reference never sets top_k at all)
        gens = [r.gen if r is not None else GenerationConfig()
                for r in self.active]
        # per-slot request keys + sampled-token counters: token t of a
        # request samples with fold_in(req.key, t) on device
        keys = np.stack([r.key if r is not None else _ZERO_KEY
                         for r in self.active]).astype(np.int64)
        ctrs = np.asarray([len(r.tokens) if r is not None else 0
                           for r in self.active], np.int64)
        top_ks = {g.top_k for g, a in zip(gens, active_mask) if a}
        k_eff = min(self.decode_chunk, self._chunk_budget())
        # floor to a power of two, as seed_tpu does (there every distinct
        # step count is a compiled program); kept so both schedulers cut
        # their chunks at the same places
        k_eff = 1 << (k_eff.bit_length() - 1)
        dev = self.device
        as_dev = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
        if len(top_ks) <= 1 and k_eff > 1:
            temps = np.asarray([g.temperature for g in gens], np.float32)
            tops = np.asarray([g.top_p for g in gens], np.float32)
            greedy = np.asarray(
                [(not g.do_sample) or g.temperature == 0.0 for g in gens])
            toks_dev, self.cache = self._decode_sample_steps(
                self.params, as_dev(self.next_tok), as_dev(active_mask),
                as_dev(temps), as_dev(tops), as_dev(greedy), self.cache,
                as_dev(keys), as_dev(ctrs),
                steps=k_eff, top_k=(top_ks.pop() if top_ks else 0))
            toks = toks_dev.cpu().numpy()       # [k_eff, slots], ONE transfer
            live = [self.active[s] is not None for s in range(self.slots)]
            for t in range(k_eff):
                for slot in range(self.slots):
                    if not live[slot]:
                        continue            # finished mid-chunk: discard tail
                    req = self.active[slot]
                    tok = int(toks[t, slot])
                    req.tokens.append(tok)
                    self.next_tok[slot] = tok
                    self._maybe_finish(slot)   # clears the slot when done
                    live[slot] = self.active[slot] is not None
            return
        if len(top_ks) > 1:
            logits, self.cache = self._decode(
                self.params, as_dev(ids), as_dev(active_mask), self.cache)
            toks = np.asarray([
                self._pick(logits[s:s + 1], self.active[s])
                if self.active[s] is not None else 0
                for s in range(self.slots)], np.int64)
        else:
            temps = np.asarray([g.temperature for g in gens], np.float32)
            tops = np.asarray([g.top_p for g in gens], np.float32)
            greedy = np.asarray(
                [(not g.do_sample) or g.temperature == 0.0 for g in gens])
            tok_dev, self.cache = self._decode_sample(
                self.params, as_dev(ids), as_dev(active_mask), as_dev(temps),
                as_dev(tops), as_dev(greedy), self.cache, as_dev(keys),
                as_dev(ctrs), top_k=(top_ks.pop() if top_ks else 0))
            toks = tok_dev.cpu().numpy()        # ONE transfer for all slots
        for slot in range(self.slots):
            req = self.active[slot]
            if req is None:
                continue
            tok = int(toks[slot])
            req.tokens.append(tok)
            self.next_tok[slot] = tok
            self._maybe_finish(slot)


class ScheduledEngine:
    """Engine-compatible facade over :class:`ContinuousBatcher` + a drain
    thread: concurrent callers (the HTTP server's request threads) submit
    into one shared slot pool and their requests batch onto the SAME decode
    steps, instead of each request serializing a private engine call.

    Exposes exactly the surface the serving stack uses
    (``generate(prompts, gen, seed) -> List[List[int]]``), so
    ``SeedLlamaInterface``, and with it the offloaded tokenizer path,
    composes unchanged.

    Thread contract: the batcher is single-threaded; all mutation happens
    under one lock. ``step()`` (device work + one host transfer) runs
    holding it, submitters/waiters take it only briefly.
    """

    def __init__(self, params, cfg: M.LlamaConfig, slots: int = 8,
                 max_len: Optional[int] = None,
                 prompt_buckets: Sequence[int] = (32, 64, 128, 256, 512),
                 cache_dtype=torch.bfloat16, seed: int = 0,
                 decode_chunk: int = 8, device="cuda"):
        self.batcher = ContinuousBatcher(
            params, cfg, slots=slots, max_len=max_len,
            prompt_buckets=prompt_buckets, cache_dtype=cache_dtype,
            seed=seed, decode_chunk=decode_chunk, device=device)
        self._cv = threading.Condition()
        self._closed = False
        self._error: Optional[Exception] = None
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def register_prefix(self, prefix: Sequence[int]) -> None:
        with self._cv, torch.inference_mode():
            self.batcher.register_prefix(prefix)

    def generate(self, prompts: Sequence[Sequence[int]],
                 gen: Optional[GenerationConfig] = None,
                 seed: Optional[int] = None) -> List[List[int]]:
        """Blocks until all ``prompts`` finish; safe from many threads.

        ``seed`` seeds PER-REQUEST sampling keys (prompt i gets
        key (seed, 0x80000000 + i)), reproducible regardless of what other
        requests are in flight, because each request samples from its own
        key stream (slot_decode_sample docstring)."""
        with self._cv:
            rids = [self.batcher.submit(
                list(p), gen,
                key=None if seed is None else
                np.array([np.uint32(seed), np.uint32(0x80000000 + i)],
                         np.uint32))
                for i, p in enumerate(prompts)]
            self._cv.notify_all()
            self._cv.wait_for(
                lambda: self._error is not None
                or all(r in self.batcher.finished for r in rids))
            if self._error is not None:
                raise RuntimeError(
                    "serving drain thread died") from self._error
            # pop: a long-running server must not retain every finished
            # request (prompt + tokens) forever
            return [self.batcher.finished.pop(r).tokens for r in rids]

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join()

    def _drain(self):
        while True:
            with self._cv:
                self._cv.wait_for(
                    lambda: self._closed or self.batcher.has_work())
                if self._closed:
                    return
                try:
                    self.batcher.step()
                except Exception as e:       # wake waiters, don't hang them
                    self._error = e
                    self._cv.notify_all()
                    return
                self._cv.notify_all()
