"""LLaMA-architecture models served by the port's continuous batcher.

The deployment ``serving/server.py --scheduler --slot-cache fp8`` runs:
``seed_tpu_torch.serving.scheduler.ContinuousBatcher`` over
``models/llama.py``'s slot programs, int8 weights for every projection and
the lm_head (the layout of ``ops/quantization.DEFAULT_TARGETS``: per output
channel ``{"kernel_q": int8 [in, out], "scale": fp32 [out]}``), bf16
embedding and norms, an fp8 e4m3 slot cache, decode chunks of
``decode_chunk`` steps.

The benchmark makes the weights itself, on the device, from the seed, in a
few large calls, and hands the same tensors to the program and to the
reference. Requests come from the mix's open-loop generator
(``core/traffic.py`` by default) and are timed from when they were due.
"""
from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from h100bench.core import traffic as T
from h100bench.core.bench import open_loop, reference_module

CODE_STD = 127.0 / math.sqrt(3.0)     # std of codes uniform in [-127, 127]


@dataclass(frozen=True)
class Spec:
    """The sizes the yardstick's work functions read."""
    dim: int
    ffn_dim: int
    layers: int
    heads: int
    kv_heads: int
    vocab: int
    rope_theta: float
    rms_eps: float
    max_len: int

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


def spec_of(config: dict) -> Spec:
    return Spec(config["hidden_size"], config["intermediate_size"],
                config["num_hidden_layers"], config["num_attention_heads"],
                config["num_key_value_heads"], config["vocab_size"],
                float(config["rope_theta"]), float(config["rms_norm_eps"]),
                config["max_position_embeddings"])


def _linears(s: Spec):
    kv = s.kv_heads * s.head_dim
    return [("q_proj", s.dim, s.dim), ("k_proj", s.dim, kv),
            ("v_proj", s.dim, kv), ("o_proj", s.dim, s.dim),
            ("gate_proj", s.dim, s.ffn_dim), ("up_proj", s.dim, s.ffn_dim),
            ("down_proj", s.ffn_dim, s.dim)]


@torch.no_grad()
def make_weights(s: Spec, seed: int, device) -> dict:
    """Seeded int8 serving weights in the port's tree layout: one int8 draw
    for every projection and the lm_head, one fp32 draw for their scales
    (std fan_in^-1/2 times 0.75-1.25 per output channel), one bf16 draw for
    the embedding (std 0.02); norms at one."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    lin = _linears(s)
    per_layer = sum(k * n for _, k, n in lin)
    n_codes = s.layers * per_layer + s.dim * s.vocab
    codes = torch.randint(-127, 128, (n_codes,), generator=g,
                          dtype=torch.int8, device=device)
    fans = [k for _ in range(s.layers) for _, k, n in lin] + [s.dim]
    widths = [n for _ in range(s.layers) for _, k, n in lin] + [s.vocab]
    fan = torch.repeat_interleave(
        torch.tensor(fans, dtype=torch.float32, device=device),
        torch.tensor(widths, device=device))
    scales = torch.rand(fan.numel(), generator=g, device=device)
    scales.mul_(0.5).add_(0.75).mul_(fan.rsqrt_()).div_(CODE_STD)
    emb = torch.randn((s.vocab, s.dim), generator=g, dtype=torch.bfloat16,
                      device=device).mul_(0.02)
    ones = lambda: {"scale": torch.ones(s.dim, dtype=torch.bfloat16,
                                        device=device)}
    oc, os_ = 0, 0

    def take(k: int, n: int) -> dict:
        nonlocal oc, os_
        p = {"kernel_q": codes[oc:oc + k * n].view(k, n),
             "scale": scales[os_:os_ + n]}
        oc += k * n
        os_ += n
        return p

    layers = []
    for _ in range(s.layers):
        lp = {name: take(k, n) for name, k, n in lin}
        lp["input_layernorm"] = ones()
        lp["post_attention_layernorm"] = ones()
        layers.append(lp)
    return {"embed_tokens": {"embedding": emb}, "layers": layers,
            "norm": ones(), "lm_head": take(s.dim, s.vocab)}


@dataclass
class Served:
    """One request of the schedule and what became of it."""
    req: T.Request
    rid: int = -1
    due: float = 0.0              # absolute host time
    t_first: Optional[float] = None   # first token the model computed
    n_first: int = 1              # tokens held when that token came
    failed: bool = False


class LlamaCell:
    def __init__(self, config: dict, mix: dict, seed: int, seconds: float,
                 device, tracer):
        from seed_tpu_torch.models import llama as M
        from seed_tpu_torch.serving.scheduler import ContinuousBatcher
        self.config, self.mix, self.seed = config, mix, seed
        self.seconds = float(seconds)
        self.device = torch.device(device)
        self.tracer = tracer
        self.spec = s = spec_of(config)
        dep = config["deployment"]
        self.cfg = M.LlamaConfig(
            vocab_size=s.vocab, dim=s.dim, layers=s.layers, heads=s.heads,
            kv_heads=s.kv_heads, ffn_dim=s.ffn_dim, max_seq_len=s.max_len,
            rope_theta=s.rope_theta, rms_eps=s.rms_eps)
        if dep["cache"] != "fp8":
            raise ValueError("the slot cache is served in fp8 e4m3")
        self.cache_bytes = 1
        self.weights = make_weights(s, seed, self.device)
        self.requests = open_loop(mix)(mix, seed, self.seconds, s.vocab,
                                       s.max_len)
        self.batcher = ContinuousBatcher(
            self.weights, self.cfg, slots=dep["slots"], max_len=s.max_len,
            prompt_buckets=tuple(dep["prompt_buckets"]),
            cache_dtype=torch.float8_e4m3fn, seed=seed % (1 << 32),
            decode_chunk=dep["decode_chunk"], device=self.device)
        self._trace_calls()
        self.served: List[Served] = []
        self.attempted = self.failed = 0

    # ------------------------------ spans ------------------------------------

    def _trace_calls(self) -> None:
        b, tr = self.batcher, self.tracer

        def pre(params, ids, n_eff, slot, *rest):
            start = rest[0] if len(rest) == 2 else 0
            return {"m": int(ids.shape[1]), "n": int(n_eff),
                    "start": int(start)}

        def pre_install(params, kv, ids, n_eff, slot, start, cache):
            return pre(params, ids, n_eff, slot, start, cache)

        def dec(*args, steps: int = 1, **kw):
            ctx = [len(r.prompt) + len(r.tokens) - 1 for r in b.active
                   if r is not None]
            return {"steps": int(steps), "ctx": ctx}

        tr.wrap(b, "_prefill", "prefill", pre)
        tr.wrap(b, "_prefill_at", "prefill_at", pre)
        tr.wrap(b, "_install_prefill", "prefill_install", pre_install)
        tr.wrap(b, "_decode_sample_steps", "decode_steps", dec)
        tr.wrap(b, "_decode_sample", "decode_sample", dec)
        tr.wrap(b, "_decode", "decode", dec)

    # ----------------------------- set-up ------------------------------------

    def _gen(self, r: T.Request):
        from seed_tpu_torch.serving.engine import GenerationConfig
        return GenerationConfig(
            max_new_tokens=r.max_new_tokens,
            temperature=float(self.mix["temperature"]),
            top_p=float(self.mix["top_p"]), do_sample=not r.greedy,
            # an id past the vocabulary: no sample ends a request early
            eos_token_id=self.spec.vocab,
            forced_first_token=(self.config["deployment"]["boi_token_id"]
                                if r.forced_first else None))

    @torch.inference_mode()
    def warm(self) -> None:
        """Each prefill bucket the schedule reaches, from position 0 and from
        a later chunk, then one decode chunk. The port runs eagerly: decode
        chunks of 1, 2 and 4 steps run the kernels of the 8-step chunk."""
        b = self.batcher
        top = b.buckets[-1]
        need = set()
        for r in self.requests:
            n, pos = len(r.prompt), 0
            while pos < n:
                k = min(n - pos, top)
                need.add((b._bucket(k), pos > 0))
                pos += k
        rng = np.random.default_rng(1)
        for m, later in sorted(need):
            n = m + (top if later else 0)
            b.submit(rng.integers(3, self.spec.vocab, n).tolist(),
                     self._gen(T.Request(-1, 0.0, [], 2, True, False)))
        b.run()
        b.finished.clear()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    # ----------------------------- window ------------------------------------

    @torch.inference_mode()
    def window(self, t_start: float) -> None:
        b, tr = self.batcher, self.tracer
        reqs = self.requests
        lead = float(self.mix["lead_in_s"])
        prof = self.mix.get("profile", {})
        origin = time.perf_counter()
        ws, we = origin + lead, origin + lead + self.seconds
        p0 = ws + float(prof.get("start_s", 0.0))
        p1 = p0 + float(prof.get("seconds", 0.0))
        self.setup_s = ws - t_start
        pending = {}
        i, late = 0, []
        self.in_flight_open = None
        while True:
            now = time.perf_counter()
            if self.in_flight_open is None and now >= ws:
                self.in_flight_open = len(b.queue) + sum(
                    r is not None for r in b.active)
            if now >= we:
                break
            if tr.on and not tr.profiling and not tr.profiles and now >= p0:
                tr.start_profile()
            elif tr.profiling and now >= p1:
                tr.stop_profile()
            while i < len(reqs) and origin + reqs[i].due_s <= now:
                r = reqs[i]
                sv = Served(r, due=origin + r.due_s)
                late.append(now - sv.due)
                try:
                    sv.rid = b.submit(r.prompt, self._gen(r),
                                      key=np.array([self.seed % (1 << 32),
                                                    r.index], np.uint32))
                    pending[sv.rid] = sv
                except ValueError:
                    sv.failed = True
                self.served.append(sv)
                i += 1
            if b.has_work():
                b.step()
            else:
                nxt = origin + reqs[i].due_s if i < len(reqs) else we
                time.sleep(max(0.0, min(nxt, we) - time.perf_counter()))
            t = time.perf_counter()
            self._note_first(pending, t)
        if tr.profiling:
            tr.stop_profile()
        self.t_stop = time.perf_counter()
        self.window_bounds = (ws, self.t_stop)
        self.ws, self.we = ws, we
        self.late = late
        self._count()

    def _note_first(self, pending: Dict[int, Served], t: float) -> None:
        """The time of each request's first computed token: ``t_first`` of
        the batcher (taken after the host read the sampled token), or, where
        the first token was forced and needs no model, the end of the step
        that brought the second."""
        b = self.batcher
        reqs = {r.request_id: r for r in b.active if r is not None}
        for rid in list(pending):
            sv = pending[rid]
            r = reqs.get(rid) or b.finished.get(rid)
            if r is None:
                continue
            if not sv.req.forced_first:
                if r.tokens:
                    sv.t_first, sv.n_first = r.t_first, 1
            elif len(r.tokens) >= 2:
                sv.t_first, sv.n_first = t, len(r.tokens)
            if sv.t_first is not None:
                del pending[rid]

    # ------------------------------ metrics ----------------------------------

    def _request(self, rid: int):
        b = self.batcher
        if rid in b.finished:
            return b.finished[rid]
        for r in b.active:
            if r is not None and r.request_id == rid:
                return r
        return None

    def timings(self):
        """(ttft seconds, tpot seconds or None) of every request due in the
        window. TPOT is the time from the first computed token's arrival to
        the last token's over the tokens that came after it. A request still
        running when the window closed is measured to that moment: its TTFT
        is the wait so far if no token came, its TPOT is over the tokens it
        had."""
        out = []
        for sv in self.served:
            if not (self.ws <= sv.due < self.we) or sv.failed:
                continue
            if sv.t_first is None:
                out.append((self.t_stop - sv.due, None))
                continue
            r = self._request(sv.rid)
            end = r.t_done if r.done else self.t_stop
            n_after = len(r.tokens) - sv.n_first
            out.append((sv.t_first - sv.due,
                        (end - sv.t_first) / max(1, n_after)))
        return out

    def _count(self) -> None:
        due = [sv for sv in self.served if self.ws <= sv.due < self.we]
        self.attempted = len(due)
        self.failed = sum(sv.failed for sv in due)

    def end_to_end(self) -> dict:
        tm = self.timings()
        return {"ttft_p95_ms": p95([a for a, _ in tm]) * 1e3,
                "tpot_p95_ms": p95([b for _, b in tm if b is not None]) * 1e3,
                "setup_s": self.setup_s}

    def summary(self) -> dict:
        tm = self.timings()
        ttft = [a for a, _ in tm]
        tpot = [b for _, b in tm if b is not None]
        fin = sum(1 for sv in self.served if self.ws <= sv.due < self.we
                  and sv.rid in self.batcher.finished)
        return {"requests_in_window": len(tm), "finished_in_window": fin,
                "queue_at_close": len(self.batcher.queue),
                "in_flight_at_open": self.in_flight_open,
                "in_flight_at_close": len(self.batcher.queue) + sum(
                    r is not None for r in self.batcher.active),
                "ttft_ms_p50": median(ttft) * 1e3,
                "ttft_ms_p95": p95(ttft) * 1e3,
                "tpot_ms_p50": median(tpot) * 1e3,
                "tpot_ms_p95": p95(tpot) * 1e3,
                "tpot_samples": len(tpot),
                "generator_late_ms_mean": float(np.mean(self.late)) * 1e3,
                "generator_late_ms_max": float(np.max(self.late)) * 1e3,
                "window_s": self.t_stop - self.ws, "setup_s": self.setup_s}

    # ------------------------------- check -----------------------------------

    def release(self) -> None:
        """Free the program's state (the slot cache above all) before the
        reference runs; keep the requests' tokens on the host."""
        b = self.batcher
        self.outputs = {rid: (list(r.prompt), list(r.tokens), r.done)
                        for rid, r in list(b.finished.items())
                        + [(r.request_id, r) for r in b.active
                           if r is not None]}
        self.batcher = None
        del b
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _pick(self, greedy: bool, seed: int) -> List[tuple]:
        """A sample drawn from ``seed`` of the finished greedy (or sampled)
        requests, the longest among them: (prompt, served tokens, first
        model token's index). Due in the window where there are any."""
        fin = [(sv, self.outputs[sv.rid]) for sv in self.served
               if sv.rid in self.outputs and self.outputs[sv.rid][2]
               and sv.req.greedy == greedy]
        inside = [x for x in fin if self.ws <= x[0].due < self.we]
        pool = inside or fin
        if not pool:
            return []
        limits = self.config["check"]
        pool.sort(key=lambda x: -(len(x[1][0]) + len(x[1][1])))
        rng = np.random.default_rng(seed)
        rest = [pool[j] for j in rng.permutation(len(pool) - 1) + 1]
        picked, toks, served = [], 0, 0
        for sv, (prompt, tokens, _) in [pool[0]] + rest:
            n = len(prompt) + len(tokens)
            if picked and (toks + n > limits["max_reference_tokens"]
                           or served >= limits["served_tokens"]):
                break
            first = 1 if sv.req.forced_first else 0
            picked.append((prompt, tokens, first))
            toks += n
            served += len(tokens) - first
        return picked

    def _compare(self, control: bool = False) -> dict:
        """Greedy requests by ``mean_gap``, sampled ones by ``nucleus_excess``
        (reference/llama_arch.compare), each sample up to the check's
        ``served_tokens``."""
        return reference_module("llama_arch").compare(
            self.weights, self.spec, self._pick(True, self.seed + 7),
            self._pick(False, self.seed + 8), float(self.mix["temperature"]),
            float(self.mix["top_p"]), self.device, control=control,
            seed=self.seed)

    def check(self) -> list:
        """Each number the configuration states a limit for. Both are
        printed; ``nucleus_excess`` has no limit while the port's sampler
        draws outside its own nucleus, since no run of it is sound there
        (PERF.md, Open questions)."""
        r = self._compare()
        print(json.dumps(r), flush=True)
        lim = self.config["check"]
        # a sample that came out empty compares nothing: not correct
        empty = sum(k not in r for k in ("mean_gap", "nucleus_excess"))
        return [{"name": k, "value": r[k], "limit": lim[k]}
                for k in ("mean_gap", "nucleus_excess")
                if k in r and k in lim] + [
                    {"name": "empty_samples", "value": empty, "limit": 0}]

    def control(self) -> dict:
        """The control's readings at the positions of the same samples
        (control.py): the lower-precision reference's tokens in place of
        the served ones."""
        return self._compare(control=True)


def p95(xs: List[float]) -> float:
    """Nearest-rank 95th percentile."""
    xs = sorted(xs)
    if not xs:
        return float("nan")
    return xs[max(0, math.ceil(0.95 * len(xs)) - 1)]


def median(xs: List[float]) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def build(config, mix, seed, seconds, device, tracer) -> LlamaCell:
    return LlamaCell(config, mix, seed, seconds, device, tracer)
