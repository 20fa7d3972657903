"""The port's program spans (``utils/metrics_logging.span``) on the tokenizer
encode path: off without a profiler, the span tree of one preprocess +
encode under a CPU profiler, its clock shared with the profiler's events,
and (on the card) device times that add up."""
import json
import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from seed_tpu_torch.models import seed_tokenizer as ST
from seed_tpu_torch.ops.preprocess import preprocess
from seed_tpu_torch.utils import metrics_logging as ML

CFG = ST.TINY_TOKENIZER


def _encode(device="cpu"):
    gen = torch.Generator(device=device).manual_seed(0)
    params = ST.init_seed_tokenizer(gen, CFG, device=device)
    size = CFG.vit.image_size
    raw = torch.randint(0, 256, (3, size, size, 3), dtype=torch.uint8,
                        generator=gen, device=device)
    return lambda: ST.encode(params, preprocess(raw, size, torch.float32),
                             CFG)


@pytest.fixture
def spans():
    ML.clear_spans()
    yield
    ML.clear_spans()


def _traced(fn, device="cpu"):
    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        out = fn()
    return out, prof, ML.recorded_spans()


def _children(recs):
    kids = {}
    for r in recs:
        kids.setdefault(r.parent_id, []).append(r)
    return kids


def test_spans_off_record_nothing_and_ids_match(spans):
    encode = _encode()
    ids = encode()
    assert ML.recorded_spans() == []
    assert ML.span("vit") is ML.span("linear", ids, images=3)
    off = ML.span("vit")
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with ML.span("linear", ids):
                pass
        grown = tracemalloc.take_snapshot().compare_to(before, "filename")
    finally:
        tracemalloc.stop()
    assert not [s for s in grown if s.size_diff > 0
                and s.traceback[0].filename == ML.__file__]
    assert ML.span("vit") is off
    traced, _, recs = _traced(encode)
    assert recs and torch.equal(ids, traced)


def test_span_tree_of_one_encode(spans):
    _, _, recs = _traced(_encode())
    by_id = {r.span_id: r for r in recs}
    roots = [r for r in recs if r.parent_id is None]
    assert [r.name for r in roots] == ["preprocess", "tokenizer.encode"]
    assert [r.counts for r in roots] == [{"images": 3}, {"images": 3}]
    enc = roots[1]
    assert {r.root_id for r in recs if r is not roots[0]} == {enc.span_id}
    assert roots[0].root_id == roots[0].span_id
    kids = _children(recs)
    assert sorted(r.name for r in kids[enc.span_id]) == [
        "layer_norm", "linear", "linear", "qformer", "vit"]
    vit = next(r for r in recs if r.name == "vit")
    depth = CFG.vit.depth
    below = sorted(r.name for r in kids[vit.span_id])
    assert below == sorted(["linear"] * (4 * depth + 1)
                           + ["layer_norm"] * (2 * depth)
                           + ["attention"] * depth + ["act"] * depth)
    for r in recs:
        assert r.device_ms is None and r.device_self_ms is None
        assert r.start_ns <= r.end_ns and r.self_ns >= 0
        assert r.self_ns == (r.end_ns - r.start_ns - sum(
            c.end_ns - c.start_ns for c in kids.get(r.span_id, [])))
        if r.parent_id is not None:
            p = by_id[r.parent_id]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns


def test_span_brackets_its_record_function_event(spans):
    _, prof, recs = _traced(_encode())
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(ML.SPAN_PREFIX):
            events.setdefault(e.name()[len(ML.SPAN_PREFIX):], []).append(
                (e.start_ns(), e.end_ns()))
    assert sum(map(len, events.values())) == len(recs)
    for name, evs in events.items():
        mine = sorted((r.start_ns, r.end_ns) for r in recs if r.name == name)
        for (a, b), (ea, eb) in zip(mine, sorted(evs)):
            assert a <= ea <= eb <= b, name


def test_profile_trace_shows_the_spans_then_spans_go_off(spans, tmp_path):
    encode = _encode()
    with ML.profile_trace(str(tmp_path)):
        encode()
    (trace,) = tmp_path.glob("trace_*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    for span in ("preprocess", "tokenizer.encode", "vit", "attention", "act",
                 "linear", "layer_norm", "qformer"):
        assert ML.SPAN_PREFIX + span in names
    n = len(ML.recorded_spans())
    encode()
    assert len(ML.recorded_spans()) == n
    assert ML.span("vit") is ML.span("qformer")
    ML.clear_spans()
    assert ML.recorded_spans() == []


@pytest.mark.cuda
def test_device_times_add_up_on_the_card(spans):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA events time the device")
    encode = _encode("cuda")
    encode()
    torch.cuda.synchronize()
    _, _, recs = _traced(encode, "cuda")
    kids = _children(recs)
    for r in recs:
        assert r.device_ms > 0, r
        below = sum(c.device_ms for c in kids.get(r.span_id, []))
        assert r.device_self_ms + below == pytest.approx(r.device_ms,
                                                         rel=1e-9)
