"""Continuous batching of seed_tpu_torch on the CPU: the slot programs and
the ContinuousBatcher against seed_tpu's on bridged weights, and the port's
counterparts of every case of tests/test_scheduler.py (per-slot cache
semantics, scheduler correctness, chunked scheduling, the ScheduledEngine).
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seed_tpu.models import llama as JM
from seed_tpu.serving import engine as JE
from seed_tpu.serving import scheduler as JSCH
from seed_tpu_torch import bridge
from seed_tpu_torch.models import llama as M
from seed_tpu_torch.serving import (ByteTextTokenizer, GenerationConfig,
                                    LlamaEngine, SeedLlamaInterface)
from seed_tpu_torch.serving.scheduler import ContinuousBatcher, ScheduledEngine

JCFG, CFG = JM.TINY_LLAMA, M.TINY_LLAMA
F32 = dict(cache_dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def both():
    jp = JM.init_llama(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)
    return jp, bridge.from_seed_tpu(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def params(both):
    return both[1]


def padded(seq, n):
    out = np.zeros((1, n), np.int64)
    out[0, :len(seq)] = seq
    return out


def port_layout(jkv):
    """seed_tpu's fused slot cache [L, B, S, H, 2D] as the port's k and v
    [L, B, H, S, D]."""
    kv = np.asarray(jkv).transpose(0, 1, 3, 2, 4)
    D = kv.shape[-1] // 2
    return kv[..., :D], kv[..., D:]


def assert_defined_rows_equal(tcache, jcache, atol=2e-5):
    """Lengths equal, and the cache rows below each slot's length."""
    lengths = np.asarray(jcache.length)
    np.testing.assert_array_equal(tcache.length.numpy(), lengths)
    jk, jv = port_layout(jcache.kv)
    for slot, n in enumerate(lengths):
        np.testing.assert_allclose(tcache.k[:, slot, :, :n].numpy(),
                                   jk[:, slot, :, :n], atol=atol)
        np.testing.assert_allclose(tcache.v[:, slot, :, :n].numpy(),
                                   jv[:, slot, :, :n], atol=atol)


class TestSlotProgramsAgainstSeedTpu:
    """Each slot program on the same inputs through both packages: logits to
    2e-4 (fp32, sum order), lengths equal, defined cache rows to 2e-5."""

    def test_slot_prefill_prefill_at_and_decode(self, both):
        jp, tp = both
        seq = [4, 8, 15, 16, 23]
        more = [42, 7, 9]
        jc = JM.init_slot_cache(JCFG, 3, 32, jnp.float32)
        tc = M.init_slot_cache(CFG, 3, 32, torch.float32, "cpu")
        jl, jc = JM.slot_prefill(jp, jnp.asarray(padded(seq, 8), jnp.int32),
                                 jnp.asarray(5), jnp.asarray(1), jc, JCFG)
        tl, tc = M.slot_prefill(tp, torch.from_numpy(padded(seq, 8)), 5, 1,
                                tc, CFG)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4)
        assert_defined_rows_equal(tc, jc)
        # a second chunk at start = 5, attending over the cached prefix
        jl, jc = JM.slot_prefill_at(jp, jnp.asarray(padded(more, 4), jnp.int32),
                                    jnp.asarray(3), jnp.asarray(1),
                                    jnp.asarray(5), jc, JCFG)
        tl, tc = M.slot_prefill_at(tp, torch.from_numpy(padded(more, 4)), 3, 1,
                                   5, tc, CFG)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4)
        assert_defined_rows_equal(tc, jc)
        assert tc.length.tolist() == [0, 8, 0]
        # two decode steps, slot 1 active, slots 0 and 2 untouched
        ids = np.zeros((3, 1), np.int64)
        ids[1, 0] = int(np.asarray(jl)[0].argmax())
        active = np.array([False, True, False])
        before = tc.k[:, [0, 2]].clone()
        for _ in range(2):
            jl, jc = JM.slot_decode(jp, jnp.asarray(ids, jnp.int32),
                                    jnp.asarray(active), jc, JCFG)
            tl, tc = M.slot_decode(tp, torch.from_numpy(ids),
                                   torch.from_numpy(active), tc, CFG)
            np.testing.assert_allclose(tl.numpy()[1], np.asarray(jl)[1],
                                       atol=2e-4)
            ids[1, 0] = int(np.asarray(jl)[1].argmax())
        assert_defined_rows_equal(tc, jc)
        assert tc.length.tolist() == [0, 10, 0]
        assert torch.equal(tc.k[:, [0, 2]], before)

    def test_install_prefix_and_prefill_at_with_prefix_kv(self, both):
        jp, tp = both
        system, rest = [7, 3, 9, 1], [5, 2, 6]
        js = JM.init_slot_cache(JCFG, 1, 32, jnp.float32)
        ts = M.init_slot_cache(CFG, 1, 32, torch.float32, "cpu")
        _, js = JM.slot_prefill(jp, jnp.asarray(padded(system, 4), jnp.int32),
                                jnp.asarray(4), jnp.asarray(0), js, JCFG)
        _, ts = M.slot_prefill(tp, torch.from_numpy(padded(system, 4)), 4, 0,
                               ts, CFG)
        jpre = js.kv[:, 0, :4]                                 # [L, P, H, 2D]
        tpre = (ts.k[:, 0, :, :4].clone(), ts.v[:, 0, :, :4].clone())
        jc = JM.init_slot_cache(JCFG, 2, 32, jnp.float32)
        tc = M.init_slot_cache(CFG, 2, 32, torch.float32, "cpu")
        jl, jc = JM.install_and_prefill_at(
            jp, jpre, jnp.asarray(padded(rest, 4), jnp.int32), jnp.asarray(3),
            jnp.asarray(1), jnp.asarray(4), jc, JCFG)
        tl, tc = M.install_and_prefill_at(
            tp, tpre, torch.from_numpy(padded(rest, 4)), 3, 1, 4, tc, CFG)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4)
        assert_defined_rows_equal(tc, jc)
        assert tc.length.tolist() == [0, 7] and not tc.k[:, 0].any()
        # install_prefix alone copies the rows and leaves the length
        jc2 = JM.install_prefix(jpre, jnp.asarray(0),
                                JM.init_slot_cache(JCFG, 2, 32, jnp.float32))
        tc2 = M.install_prefix(tpre, 0, M.init_slot_cache(CFG, 2, 32,
                                                          torch.float32, "cpu"))
        jk, jv = port_layout(jc2.kv)
        np.testing.assert_allclose(tc2.k.numpy(), jk, atol=2e-5)
        np.testing.assert_allclose(tc2.v.numpy(), jv, atol=2e-5)
        assert tc2.length.tolist() == [0, 0]
        # the hit path equals prefilling the whole prompt from 0
        whole, _ = M.slot_prefill(tp, torch.from_numpy(padded(system + rest, 8)),
                                  7, 0, M.init_slot_cache(CFG, 1, 32,
                                                          torch.float32, "cpu"),
                                  CFG)
        np.testing.assert_allclose(tl.numpy(), whole.numpy(), atol=2e-4)

    def test_fp8_slot_cache_is_a_cast(self, both):
        """fp8 slots: the stored bytes are the cast of the fp32 slots' rows."""
        _, tp = both
        seq = [4, 8, 15, 16, 23]
        ref = M.init_slot_cache(CFG, 2, 16, torch.float32, "cpu")
        fp8 = M.init_slot_cache(CFG, 2, 16, torch.float8_e4m3fn, "cpu")
        l32, ref = M.slot_prefill(tp, torch.from_numpy(padded(seq, 8)), 5, 1,
                                  ref, CFG)
        l8, fp8 = M.slot_prefill(tp, torch.from_numpy(padded(seq, 8)), 5, 1,
                                 fp8, CFG)
        # slot_prefill attends over the fresh k, v: logits do not see the cache
        assert torch.equal(l32, l8)
        want = M._cache_cast(ref.k[:, 1, :, :5], torch.float8_e4m3fn)
        assert torch.equal(fp8.k[:, 1, :, :5].view(torch.uint8),
                           want.view(torch.uint8))
        ids = torch.tensor([[0], [int(l8[0].argmax())]])
        active = torch.tensor([False, True])
        d32, _ = M.slot_decode(tp, ids, active, ref, CFG)
        d8, fp8 = M.slot_decode(tp, ids, active, fp8, CFG)
        assert fp8.length.tolist() == [0, 6] and not fp8.k[:, 0].float().any()
        # e4m3 keeps 3 mantissa bits (steps of 6%): logits of scale 2.5
        # agree to 0.25
        np.testing.assert_allclose(d8[1].numpy(), d32[1].numpy(), atol=0.25)
        with pytest.raises(ValueError, match="no int8 mode"):
            M.init_slot_cache(CFG, 2, 16, torch.int8, "cpu")

    def test_steps_equal_single_steps_and_streams_are_per_request(self, both):
        """slot_decode_sample_steps(steps=k) gives the tokens of k single
        steps, sampled rows included, and a slot's tokens do not depend on
        what the other slot holds."""
        _, tp = both

        def filled(other):
            c = M.init_slot_cache(CFG, 2, 32, torch.float32, "cpu")
            _, c = M.slot_prefill(tp, torch.from_numpy(padded([1, 5, 9], 4)),
                                  3, 0, c, CFG)
            _, c = M.slot_prefill(tp, torch.from_numpy(padded(other, 4)),
                                  len(other), 1, c, CFG)
            return c
        tok0 = torch.tensor([11, 12])
        active = torch.tensor([True, True])
        temp, top_p = torch.tensor([0.9, 1.0]), torch.tensor([0.8, 1.0])
        greedy = torch.tensor([False, True])
        keys = torch.tensor([[1234, 7], [0, 0]])
        ctr = torch.tensor([1, 1])
        many, _ = M.slot_decode_sample_steps(tp, tok0, active, temp, top_p,
                                             greedy, filled([2, 7]), keys, ctr,
                                             CFG, steps=4)
        cache, tok, single = filled([2, 7]), tok0, []
        for t in range(4):
            tok, cache = M.slot_decode_sample(tp, tok[:, None], active, temp,
                                              top_p, greedy, cache, keys,
                                              ctr + t, CFG)
            single.append(tok)
        assert torch.equal(many, torch.stack(single))
        assert many.shape == (4, 2) and cache.length.tolist() == [7, 6]
        other, _ = M.slot_decode_sample_steps(
            tp, torch.tensor([11, 40]), active, temp, top_p,
            torch.tensor([False, False]), filled([3, 3, 3]),
            torch.tensor([[1234, 7], [5, 5]]), torch.tensor([1, 9]), CFG,
            steps=4)
        assert torch.equal(other[:, 0], many[:, 0])


class TestSlotCache:
    def test_slot_prefill_matches_batch_prefill(self, params):
        """A slot-prefilled prompt must yield the same next-token logits as
        the batch engine's prefill."""
        seq = [4, 8, 15, 16, 23]
        cache0 = M.init_cache(CFG, 1, 32, torch.float32, "cpu")
        l0, _ = M.prefill(params, torch.tensor([seq]), cache0, CFG)
        scache = M.init_slot_cache(CFG, 3, 32, torch.float32, "cpu")
        got, scache = M.slot_prefill(params, torch.from_numpy(padded(seq, 8)),
                                     5, 1, scache, CFG)
        np.testing.assert_allclose(l0[:, -1].numpy(), got.numpy(), rtol=2e-4,
                                   atol=2e-4)
        assert scache.length.tolist() == [0, 5, 0]

    def test_slot_decode_matches_batch_decode(self, params):
        seq = [4, 8, 15]
        cache0 = M.init_cache(CFG, 1, 32, torch.float32, "cpu")
        l0, cache0 = M.prefill(params, torch.tensor([seq]), cache0, CFG)
        tok = int(l0[0, -1].argmax())
        l1, _ = M.decode_step(params, torch.tensor([[tok]]), cache0, CFG)
        scache = M.init_slot_cache(CFG, 4, 32, torch.float32, "cpu")
        _, scache = M.slot_prefill(params, torch.from_numpy(padded(seq, 8)), 3,
                                   2, scache, CFG)
        ids = torch.zeros((4, 1), dtype=torch.int64)
        ids[2, 0] = tok
        active = torch.tensor([False, False, True, False])
        logits, scache = M.slot_decode(params, ids, active, scache, CFG)
        np.testing.assert_allclose(l1[0, 0].numpy(), logits[2].numpy(),
                                   rtol=2e-4, atol=2e-4)
        assert scache.length.tolist() == [0, 0, 4, 0]   # inactive untouched

    def test_inactive_slots_preserved(self, params):
        """Decoding with one active slot must not corrupt another slot's
        cache contents."""
        scache = M.init_slot_cache(CFG, 2, 16, torch.float32, "cpu")
        _, scache = M.slot_prefill(params, torch.from_numpy(padded([4, 8, 15], 8)),
                                   3, 0, scache, CFG)
        snapshot = scache.k[:, 0].clone()
        _, scache = M.slot_decode(params, torch.zeros((2, 1), dtype=torch.int64),
                                  torch.tensor([False, True]), scache, CFG)
        assert torch.equal(snapshot, scache.k[:, 0])
        assert scache.length.tolist() == [3, 1]


def batcher(params, **kw):
    kw = {"slots": 2, "max_len": 64, **F32, **kw}
    return ContinuousBatcher(params, CFG, **kw)


def engine(params, max_len=64):
    return LlamaEngine(params, CFG, max_len=max_len, **F32)


def greedy(n, eos=-1):
    return GenerationConfig(max_new_tokens=n, do_sample=False, eos_token_id=eos)


def counting_installs(cb):
    installs = []
    real = cb._install_prefill
    cb._install_prefill = lambda *a, **k: (installs.append(1), real(*a, **k))[1]
    return installs


class TestContinuousBatcher:
    def test_matches_engine_greedy(self, params):
        gen = greedy(6)
        want = engine(params).generate([[1, 5, 9]], gen)[0]
        cb = batcher(params)
        rid = cb.submit([1, 5, 9], gen)
        assert cb.run()[rid] == want

    def test_more_requests_than_slots(self, params):
        gen = greedy(4)
        cb = batcher(params)
        prompts = [[1, 5, 9], [2, 7], [3, 3, 3, 3], [11, 12]]
        rids = [cb.submit(p, gen) for p in prompts]
        out = cb.run()
        assert set(out) == set(rids)
        eng = engine(params)
        for rid, p in zip(rids, prompts):
            assert out[rid] == eng.generate([p], gen)[0], p

    def test_interleaved_admission(self, params):
        """A request submitted while others are decoding still completes
        and matches the solo result."""
        gen = greedy(5)
        cb = batcher(params)
        r1 = cb.submit([1, 5, 9], gen)
        cb.step()
        cb.step()
        r2 = cb.submit([2, 7, 4], gen)  # admitted mid-flight
        out = cb.run()
        eng = engine(params)
        assert out[r1] == eng.generate([[1, 5, 9]], gen)[0]
        assert out[r2] == eng.generate([[2, 7, 4]], gen)[0]

    def test_prefix_cache_exact_match(self, params):
        """register_prefix + shared-prefix prompts produce exactly the
        tokens of the uncached path (fp32 cache: the chunk attends over the
        same prefix KV values)."""
        gen = greedy(5)
        system = [7, 3, 9, 1]
        prompts = [system + [5, 2], system + [8], [4, 4, 2]]  # last: no hit
        plain = batcher(params)
        rids_p = [plain.submit(p, gen) for p in prompts]
        want = plain.run()
        cached = batcher(params)
        cached.register_prefix(system)
        assert tuple(system) in cached.prefixes
        rids_c = [cached.submit(p, gen) for p in prompts]
        got = cached.run()
        for rp, rc, prompt in zip(rids_p, rids_c, prompts):
            assert want[rp] == got[rc], prompt

    def test_prefix_install_skipped_on_slot_reuse(self, params):
        """A slot re-admitted with the same shared prefix must NOT pay the
        install again (decode and start>0 prefills never touch cache
        positions [0, len(prefix))), and a from-0 prefill must invalidate
        the slot so a later hit re-installs. Tokens stay equal to the
        uncached path throughout."""
        gen = greedy(4)
        system = [7, 3, 9, 1]
        hits = [system + [5, 2], system + [8], system + [2, 2],
                system + [6], system + [1, 5, 3]]
        miss = [4, 4, 2]
        plain = batcher(params)
        rids_p = [plain.submit(p, gen) for p in hits + [miss] + hits]
        want = plain.run()
        cached = batcher(params)
        cached.register_prefix(system)
        installs = counting_installs(cached)
        rids_c = [cached.submit(p, gen) for p in hits]
        got = cached.run()
        assert len(installs) == 2           # once per slot, then reused
        rid_m = cached.submit(miss, gen)    # from-0 prefill invalidates
        got[rid_m] = cached.run()[rid_m]
        rids_c2 = [cached.submit(p, gen) for p in hits]
        got.update(cached.run())
        assert len(installs) == 3           # the slot the miss clobbered
        for rp, rc in zip(rids_p, rids_c + [rid_m] + rids_c2):
            assert want[rp] == got[rc]

    def test_long_prompt_chunked_prefill(self, params):
        """Prompts longer than the largest bucket are prefilled in multiple
        chunks and match the solo engine exactly."""
        gen = greedy(4)
        prompt = [(i * 7 + 3) % 50 for i in range(19)]   # 19 > bucket 8
        cb = batcher(params, prompt_buckets=(4, 8))
        rid = cb.submit(prompt, gen)
        assert cb.run()[rid] == engine(params).generate([prompt], gen)[0]

    def test_long_prefix_chunked_register(self, params):
        """A registered prefix longer than the largest bucket is fully
        prefilled."""
        gen = greedy(4)
        system = [(i * 5 + 1) % 40 for i in range(13)]   # 13 > bucket 8
        prompt = system + [6, 2]
        plain = batcher(params, slots=1, prompt_buckets=(4, 8))
        rp = plain.submit(prompt, gen)
        want = plain.run()[rp]
        cached = batcher(params, slots=1, prompt_buckets=(4, 8))
        cached.register_prefix(system)
        # the pinned KV must cover the WHOLE prefix, not just bucket[-1]
        pk, pv = cached.prefixes[tuple(system)]
        assert pk.shape[2] == pv.shape[2] == len(system)
        rc = cached.submit(prompt, gen)
        assert cached.run()[rc] == want

    def test_chunk_slides_back_at_cache_end(self, params):
        """A chunk whose bucket would overrun max_len slides back and
        recomputes the overlap instead of writing past the slot's row."""
        gen = greedy(1)
        prompt = [(i * 3 + 2) % 45 for i in range(29)]   # 24+8 > 30 -> slide
        cb = batcher(params, slots=1, max_len=30, prompt_buckets=(4, 8))
        rid = cb.submit(prompt, gen)
        assert cb.run()[rid] == engine(params, 30).generate([prompt], gen)[0]

    def test_slide_back_into_prefix_invalidates_slot(self, params):
        """A chunk slide-back that rewrites positions inside an installed
        prefix must drop the slot's prefix tag, so the NEXT same-prefix
        admission re-installs instead of trusting rewritten rows."""
        gen = greedy(1)
        system = [(i * 5 + 1) % 40 for i in range(10)]   # 10 > 16 - 8
        prompt = system + [6, 2, 9, 4, 1]                # 15 tokens: slides
        plain = batcher(params, slots=1, max_len=16, prompt_buckets=(4, 8))
        rp = [plain.submit(prompt, gen), plain.submit(prompt, gen)]
        want = plain.run()
        cached = batcher(params, slots=1, max_len=16, prompt_buckets=(4, 8))
        cached.register_prefix(system)
        installs = counting_installs(cached)
        rc = [cached.submit(prompt, gen), cached.submit(prompt, gen)]
        got = cached.run()
        assert len(installs) == 2
        assert cached.slot_prefix[0] is None
        for a, b in zip(rp, rc):
            assert want[a] == got[b]

    def test_per_request_seed_reproducible_under_concurrency(self, params):
        """A seeded sampled request yields the SAME tokens whether it runs
        alone or alongside other traffic (per-request streams)."""
        gen = GenerationConfig(max_new_tokens=6, do_sample=True,
                               temperature=1.0, top_p=0.9, eos_token_id=-1)
        key = np.array([1234, 7], np.uint32)
        solo = batcher(params)
        r = solo.submit([1, 5, 9], gen, key=key)
        want = solo.run()[r]
        busy = batcher(params, decode_chunk=4)
        others = [busy.submit([2, 7], gen), busy.submit([3, 3, 3], gen)]
        r2 = busy.submit([1, 5, 9], gen, key=key)
        got = busy.run()
        assert got[r2] == want
        assert all(len(got[o]) == 6 for o in others)
        # another key gives another stream
        again = batcher(params)
        r3 = again.submit([1, 5, 9], gen, key=np.array([1234, 8], np.uint32))
        assert again.run()[r3] != want

    def test_mixed_top_k_takes_the_host_path(self, params):
        """Requests with different top_k in flight together: the slot-wise
        host path, same per-request streams, so a seeded request gives the
        tokens it gives alone."""
        key = np.array([77, 1], np.uint32)
        g5 = GenerationConfig(max_new_tokens=5, top_p=1.0, top_k=5,
                              eos_token_id=-1)
        g0 = GenerationConfig(max_new_tokens=5, top_p=0.9, eos_token_id=-1)
        solo = batcher(params)
        r = solo.submit([1, 5, 9], g5, key=key)
        want = solo.run()[r]
        mixed = batcher(params, decode_chunk=4)
        r0 = mixed.submit([2, 7], g0)
        r5 = mixed.submit([1, 5, 9], g5, key=key)
        got = mixed.run()
        assert got[r5] == want and len(got[r0]) == 5

    def test_submit_rejects_overlong_prompt(self, params):
        cb = batcher(params, slots=1, max_len=16)
        with pytest.raises(ValueError):
            cb.submit(list(range(16)))
        with pytest.raises(ValueError):
            cb.register_prefix(list(range(16)))

    def test_prefix_cache_longest_match_wins(self, params):
        cb = batcher(params, slots=1)
        cb.register_prefix([7, 3])
        cb.register_prefix([7, 3, 9, 1])
        hit = cb._match_prefix([7, 3, 9, 1, 5])
        assert hit is not None and hit[0] == 4
        # exact-length prompt: no strict prefix -> the shorter one
        assert cb._match_prefix([7, 3, 9, 1]) == (2, cb.prefixes[(7, 3)])
        assert cb._match_prefix([8, 8]) is None

    def test_request_times_and_budget(self, params):
        cb = batcher(params)
        rid = cb.submit([1, 5, 9], greedy(3))
        cb.run()
        req = cb.finished[rid]
        assert req.done and len(req.tokens) == 3
        assert req.t_submit <= req.t_first <= req.t_done


class TestChunkedScheduler:
    """Multi-step scheduling (decode_chunk > 1): k decode+sample steps per
    call, host-side truncation at eos/budget. Must be result-identical to
    single-step scheduling for greedy requests."""

    def test_chunk_matches_single_step(self, params):
        gen, short = greedy(5), greedy(2)
        prompts = [[1, 5, 9], [2, 7], [3, 3, 3, 3], [11, 12], [4, 4, 4]]
        gens = [gen, gen, short, gen, gen]   # mixed budgets
        ref = batcher(params)
        rids = [ref.submit(p, g) for p, g in zip(prompts, gens)]
        want = ref.run()
        cb = batcher(params, decode_chunk=4)
        rids2 = [cb.submit(p, g) for p, g in zip(prompts, gens)]
        got = cb.run()
        for a, b in zip(rids, rids2):
            assert got[b] == want[a]

    def test_eos_mid_chunk_discards_tail_and_readmits(self, params):
        """A slot hitting eos mid-chunk: the chunk's tail tokens are
        discarded host-side (and overwritten in the cache by the next
        admit's prefill) and the freed slot serves the next request."""
        gen0 = greedy(6)
        eng = engine(params)
        full = eng.generate([[1, 5, 9]], gen0)[0]
        gen = greedy(6, eos=full[2])       # the greedy stream's 3rd token
        cb = batcher(params, slots=1, decode_chunk=4)
        r1 = cb.submit([1, 5, 9], gen)
        r2 = cb.submit([2, 7, 4], gen0)    # reuses the slot after r1's eos
        out = cb.run()
        assert out[r1] == full[:2]
        assert out[r2] == eng.generate([[2, 7, 4]], gen0)[0]

    def test_chunk_budget_and_power_of_two_steps(self, params):
        """_chunk_budget is bounded by the cache end only, and the steps of
        a chunk are floored to a power of two."""
        cb = batcher(params, max_len=32, decode_chunk=8,
                     prompt_buckets=(4, 8, 16))
        cb.submit([1, 5, 9], greedy(2))
        cb.submit(list(range(3, 23)), greedy(40))
        cb._admit()
        assert cb._chunk_budget() == 31 - 21      # the long slot's room
        steps = []
        real = cb._decode_sample_steps
        cb._decode_sample_steps = lambda *a, **k: (steps.append(k["steps"]),
                                                   real(*a, **k))[1]
        cb.run()
        assert steps and all(s & (s - 1) == 0 and s <= 8 for s in steps)
        assert len(cb.finished[1].tokens) == 32 - 1 - 20


class TestScheduledEngine:
    """Engine facade over the batcher: the generate() surface the serving
    stack uses, a drain thread, concurrent callers on shared decode steps."""

    def test_matches_llama_engine_greedy(self, params):
        gen = greedy(5)
        eng = engine(params)
        se = ScheduledEngine(params, CFG, slots=2, max_len=64, decode_chunk=4,
                             **F32)
        try:
            prompts = [[1, 5, 9], [2, 7, 4]]
            got = se.generate(prompts, gen)
            for p, toks in zip(prompts, got):
                assert toks == eng.generate([p], gen)[0], p
            assert not se.batcher.finished          # popped, not retained
        finally:
            se.close()

    def test_concurrent_callers(self, params):
        gen = greedy(4)
        eng = engine(params)
        se = ScheduledEngine(params, CFG, slots=2, max_len=64, decode_chunk=2,
                             **F32)
        prompts = [[1, 5, 9], [2, 7], [3, 3, 3, 3], [11, 12]]
        results = [None] * len(prompts)

        def call(i):
            results[i] = se.generate([prompts[i]], gen)[0]

        try:
            threads = [threading.Thread(target=call, args=(i,))
                       for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not any(t.is_alive() for t in threads)
            for p, toks in zip(prompts, results):
                assert toks == eng.generate([p], gen)[0], p
        finally:
            se.close()

    def test_seeded_generate_reproduces(self, params):
        gen = GenerationConfig(max_new_tokens=5, top_p=0.9, eos_token_id=-1)
        se = ScheduledEngine(params, CFG, slots=2, max_len=64, **F32)
        try:
            a = se.generate([[1, 5, 9]], gen, seed=3)
            b = se.generate([[2, 7], [1, 5, 9]], gen, seed=3)
            assert se.generate([[1, 5, 9]], gen, seed=3) == a
            assert b[1] != a[0] or b[0] != a[0]     # key (seed, i): i differs
        finally:
            se.close()

    def test_drain_error_reaches_the_caller(self, params):
        se = ScheduledEngine(params, CFG, slots=1, max_len=64, **F32)
        try:
            def boom():
                raise ValueError("step failed")
            se.batcher.step = boom
            with pytest.raises(RuntimeError, match="drain thread died"):
                se.generate([[1, 5, 9]], greedy(2))
        finally:
            se.close()

    def test_composes_with_interface(self, params):
        """SeedLlamaInterface takes a ScheduledEngine where it takes a
        LlamaEngine (same generate() surface)."""
        se = ScheduledEngine(params, CFG, slots=2, max_len=64, decode_chunk=4,
                             **F32)
        try:
            gen = greedy(6)
            ref = SeedLlamaInterface(engine(params), device="cpu",
                                     text_tokenizer=ByteTextTokenizer())
            sch = SeedLlamaInterface(se, text_tokenizer=ByteTextTokenizer(),
                                     device="cpu")
            a = sch.generate(["hi"], gen=gen, seed=0)
            b = ref.generate(["hi"], gen=gen, seed=0)
            assert [s.text for s in a] == [s.text for s in b]
        finally:
            se.close()


@pytest.mark.parametrize("decode_chunk", [1, 4])
def test_batcher_greedy_streams_equal_seed_tpu(both, decode_chunk):
    """The port's ContinuousBatcher against seed_tpu's on bridged weights:
    more requests than slots, a registered prefix with hits and a miss, a
    prompt longer than the largest bucket, a forced first token, an eos that
    a stream hits; every greedy token stream equal."""
    jp, tp = both
    system = [7, 3, 9, 1]
    prompts = [system + [5, 2], [4, 4, 2], system + [8],
               [(i * 7 + 3) % 50 for i in range(19)], [2, 7], system + [6, 6, 1]]
    kw = dict(slots=2, max_len=48, prompt_buckets=(4, 8),
              decode_chunk=decode_chunk)
    probe = JSCH.ContinuousBatcher(jp, JCFG, cache_dtype=jnp.float32, **kw)
    rid = probe.submit(prompts[0], JE.GenerationConfig(
        max_new_tokens=6, do_sample=False, eos_token_id=-1))
    eos = probe.run()[rid][3]              # request 0 stops at its 4th token

    def gens(cls):
        base = dict(max_new_tokens=6, do_sample=False, eos_token_id=eos)
        return [cls(**base), cls(**base), cls(**{**base, "max_new_tokens": 3}),
                cls(**base), cls(**base, forced_first_token=9), cls(**base)]

    jcb = JSCH.ContinuousBatcher(jp, JCFG, cache_dtype=jnp.float32, **kw)
    tcb = ContinuousBatcher(tp, CFG, **F32, **kw)
    jcb.register_prefix(system)
    tcb.register_prefix(system)
    jr = [jcb.submit(p, g) for p, g in zip(prompts, gens(JE.GenerationConfig))]
    tr = [tcb.submit(p, g) for p, g in zip(prompts, gens(GenerationConfig))]
    want, got = jcb.run(), tcb.run()
    for a, b, p in zip(jr, tr, prompts):
        assert got[b] == want[a], p
    assert len(got[tr[0]]) == 3 and got[tr[4]][0] == 9
    assert tcb.slot_prefix == jcb.slot_prefix
