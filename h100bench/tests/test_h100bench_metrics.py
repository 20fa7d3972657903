"""Tails, rates and per-layer readings over all requests and spans of the
window, on synthetic spans and requests (no program involved)."""
import math
from types import SimpleNamespace as NS

import pytest

from h100bench.core import bench
from h100bench.core.trace import DeviceOp, Profile, Span
from h100bench.core.traffic import Request
from h100bench.core.work import (int8_linear_work, llama_decode_work,
                                 llama_prefill_flops, seed_encode_flops)

LLAMA = bench.kind_module("llama_arch")
TOK = bench.kind_module("seed_tokenizer")
SPEC = LLAMA.spec_of(bench.data("configs", "deepseek-llm-7b-int8"))


def test_p95_is_nearest_rank_over_all():
    xs = list(range(1, 201))
    assert LLAMA.p95(xs) == 190
    assert LLAMA.p95([5.0]) == 5.0
    assert math.isnan(LLAMA.p95([]))


def _cell(served, finished, active, ws=10.0, we=20.0, stop=21.0):
    c = object.__new__(LLAMA.LlamaCell)
    c.served, c.ws, c.we, c.t_stop = served, ws, we, stop
    c.batcher = NS(finished=finished, active=active, queue=[])
    c.late, c.setup_s = [0.0], 1.0
    return c


def _req(rid, tokens, done, t_first=0.0, t_done=0.0):
    return NS(request_id=rid, tokens=tokens, done=done, t_first=t_first,
              t_done=t_done)


def test_timings_count_running_and_unstarted_requests():
    R = lambda forced=False: Request(0, 0.0, [1, 2], 10, True, forced)
    done = LLAMA.Served(R(), rid=0, due=11.0, t_first=12.0)
    running = LLAMA.Served(R(), rid=1, due=12.0, t_first=15.0)
    waiting = LLAMA.Served(R(), rid=2, due=19.0)
    lead = LLAMA.Served(R(), rid=3, due=5.0, t_first=6.0)
    forced = LLAMA.Served(R(True), rid=4, due=13.0, t_first=14.0, n_first=9)
    cell = _cell([done, running, waiting, lead, forced],
                 {0: _req(0, list(range(11)), True, 12.0, 17.0),
                  4: _req(4, list(range(34)), True, 13.5, 19.0)},
                 [_req(1, [1, 2, 3], False)])
    tm = cell.timings()
    assert len(tm) == 4                      # the lead-in request is left out
    assert tm[0] == pytest.approx((1.0, 5.0 / 10))
    assert tm[1] == pytest.approx((3.0, (21.0 - 15.0) / 2))
    assert tm[2] == (pytest.approx(2.0), None)   # waited to the close
    assert tm[3] == pytest.approx((1.0, 5.0 / 25))
    cell._count()
    assert cell.attempted == 4 and cell.failed == 0
    e2e = cell.end_to_end()
    assert e2e["ttft_p95_ms"] == pytest.approx(3000.0)
    assert e2e["tpot_p95_ms"] == pytest.approx(3000.0)


def _run(spans, window=(0.0, 10.0), profile=None, cell=None):
    profile = profile or Profile(0.0, 1.0, [DeviceOp("k", 0, 10)], [])
    return bench.Run(cell or NS(spec=SPEC, cache_bytes=1), spans, profile,
                     window)


def test_llm_readers_on_synthetic_spans():
    spans = [Span("prefill", 1.0, 1.5, {"m": 512, "n": 400, "start": 0}),
             Span("prefill_at", 2.0, 2.5, {"m": 512, "n": 512, "start": 512}),
             Span("decode_steps", 3.0, 4.0, {"steps": 8, "ctx": [100, 200]}),
             Span("decode_steps", 9.5, 10.5, {"steps": 8, "ctx": [1]})]
    run = _run(spans)
    read = lambda n: bench.metric_reader(n)(run)
    assert read("prefill_share") == pytest.approx(10.0)
    assert read("prefill_ms_per_ktok") == pytest.approx(1000.0 / 0.912)
    assert read("decode_step_ms") == pytest.approx(125.0)
    flops = llama_prefill_flops(SPEC, 0, 400) + llama_prefill_flops(SPEC, 512, 512)
    assert read("mfu.prefill") == pytest.approx(100 * flops / 989e12)
    need = sum(max(f / 989e12, b / 3.35e12) for f, b in (
        llama_decode_work(SPEC, [100 + t, 200 + t], 1) for t in range(8)))
    assert read("mfu.decode") == pytest.approx(100 * need)
    assert 0 < read("mfu.decode") < 100


def test_readers_find_nothing_without_spans():
    run = _run([])
    for name in ("prefill_share", "decode_step_ms", "prefill_ms_per_ktok",
                 "mfu.decode", "mfu.prefill", "int8_mm_roofline",
                 "mfu.encode", "launches_per_image"):
        assert bench.metric_reader(name)(run) is None, name


def test_profile_union_gaps_and_roofline():
    ops = [DeviceOp("int8_mm_bf16", 0, 400), DeviceOp("copy", 200, 400),
           DeviceOp("int8_mm_reduce", 1000, 100), DeviceOp("gemm", 2000, 500)]
    p = Profile(0.0, 3e-6, ops, [("decode_steps", 1500, 1900)])
    assert p.busy_s() == pytest.approx(1200e-9)
    assert p.idle_gaps(2) == [["decode_steps", pytest.approx(900e-9)],
                              ["host, outside any benchmark span",
                               pytest.approx(400e-9)]]
    assert p.top_ops(1) == [["gemm", pytest.approx(500e-9)]]
    spans = [Span("prefill", 0.0, 1e-6, {"m": 256, "n": 200, "start": 0}),
             Span("prefill", 0.0, 1e-6, {"m": 64, "n": 60, "start": 0})]
    run = _run(spans, profile=p)
    need = SPEC.layers * sum(max(f / 989e12, b / 3.35e12) for f, b in (
        int8_linear_work(256, k, n) for k, n in
        [(4096, 4096)] * 4 + [(4096, 11008)] * 2 + [(11008, 4096)]))
    got = bench.metric_reader("int8_mm_roofline")(run)
    assert got == pytest.approx(100 * need / 500e-9)
    idle = bench.metric_reader("idle_share.llm")(run)
    assert idle == pytest.approx(100 * (1 - 1200e-9 / 3e-6))


def test_tokenizer_readers():
    spec = bench.data("configs", "seed2-tokenizer-bf16")
    spans = [Span("encode", 1.0, 1.5, {"images": 256}),
             Span("encode", 2.0, 2.4, {"images": 256})]
    prof = Profile(1.9, 2.5, [DeviceOp("k", 0, 10)] * 512, [])
    run = _run(spans, profile=prof, cell=NS(spec=spec))
    assert bench.metric_reader("launches_per_image")(run) == 2.0
    mfu = bench.metric_reader("mfu.encode")(run)
    assert mfu == pytest.approx(100 * 256 * seed_encode_flops(spec)
                                / (0.5 * 989e12))
    # one EVA-ViT-g/14 image at 224 is about half a TFLOP
    assert 500e9 < seed_encode_flops(spec) < 560e9


def test_closed_loop_rate_is_over_whole_calls():
    c = object.__new__(TOK.TokenizerCell)
    c.calls, c.batch, c.ws, c.t_end, c.setup_s = [0] * 30, 256, 5.0, 15.5, 2.0
    assert c.end_to_end()["images_per_s"] == pytest.approx(30 * 256 / 10.5)


def test_nucleus_floor_and_gap():
    """The reference's nucleus: the fewest most probable tokens whose mass
    reaches top-p, the token that crosses p inside; a sampled token's gap
    is how far it lies below the nucleus's smallest logit."""
    import math
    import torch
    from h100bench.core.bench import reference_module
    ref = reference_module("llama_arch")
    # probabilities 0.4, 0.3, 0.2, 0.1 at temperature 1
    lg = torch.tensor([[math.log(0.1), math.log(0.4), math.log(0.2),
                        math.log(0.3)]])
    floor = ref.nucleus_floor(lg, 1.0, 0.5)
    assert torch.allclose(floor, torch.tensor([math.log(0.3)]))
    assert torch.allclose(ref.nucleus_floor(lg, 1.0, 0.4),
                          torch.tensor([math.log(0.4)]))
    assert torch.allclose(ref.nucleus_floor(lg, 1.0, 0.75),
                          torch.tensor([math.log(0.2)]))
    # a lower temperature sharpens: at 0.5 the first token holds 16/30
    assert torch.allclose(ref.nucleus_floor(lg, 0.5, 0.5),
                          torch.tensor([math.log(0.4)]))
    g = torch.Generator().manual_seed(3)
    draws = torch.cat([ref._draw(lg, 1.0, 0.5, g) for _ in range(200)])
    assert set(draws.tolist()) == {1, 3}
