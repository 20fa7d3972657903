"""The port's program spans (``utils/metrics_logging.span``) on the tokenizer
encode path: off without a profiler, the span tree of one preprocess +
encode under a CPU profiler, its clock shared with the profiler's events,
and (on the card) device times that add up. On the de-tokenize path: off
without a profiler, and the shape of its span tree."""
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


# ------------------------- the de-tokenizer's spans --------------------------

def _detok(steps=2):
    """codes -> pixels through ``SeedLlamaInterface.decode_image`` with the
    tiny de-tokenizer attached, on the CPU."""
    import dataclasses
    from seed_tpu_torch.models.unclip import TINY_UNCLIP, UnCLIPDecoder, init_unclip
    from seed_tpu_torch.serving.multimodal import SeedLlamaInterface
    tok_cfg = dataclasses.replace(CFG, image_embed_dim=TINY_UNCLIP.image_embed_dim)
    gen = torch.Generator().manual_seed(0)
    svc = SeedLlamaInterface(
        None, ST.init_seed_tokenizer(gen, tok_cfg, device="cpu"), tok_cfg,
        diffusion=UnCLIPDecoder(init_unclip(gen, TINY_UNCLIP, device="cpu"),
                                TINY_UNCLIP, num_inference_steps=steps,
                                dtype=torch.float32, device="cpu"),
        device="cpu")
    codes = torch.randint(0, tok_cfg.codebook_size, (2, tok_cfg.qformer.query_len),
                          generator=gen).numpy()
    return lambda: svc.decode_image(codes)


def test_detok_spans_off_record_nothing(spans):
    decode = _detok()
    px = decode()
    assert ML.recorded_spans() == []
    traced, _, recs = _traced(decode)
    assert recs and (px == traced).all()


def test_detok_span_tree(spans):
    from seed_tpu_torch.models.unclip import TINY_UNCLIP
    steps = 2
    _, _, recs = _traced(_detok(steps))
    by_id = {r.span_id: r for r in recs}
    kids = _children(recs)
    roots = [r for r in recs if r.parent_id is None]
    assert [r.name for r in roots] == ["tokenizer.decode_embedding",
                                       "unclip.generate"]
    assert roots[0].counts == {"images": 2}
    assert roots[1].counts == {"images": 2, "steps": steps}
    gen = roots[1]
    assert sorted(r.name for r in kids[gen.span_id]) == ["unet"] * steps + ["vae"]
    u = TINY_UNCLIP.unet
    # transformers: L a level with attention going down, one in the middle,
    # L + 1 a level with attention going up
    blocks = sum(u.attn_levels) * (2 * u.layers_per_block + 1) + 1
    # down L, up L + 1 a level, two in the middle
    resnets = len(u.block_channels) * (2 * u.layers_per_block + 1) + 2
    for unet in (r for r in kids[gen.span_id] if r.name == "unet"):
        below = [r.name for r in kids[unet.span_id]]
        for name in ("self_attention", "cross_attention", "ff"):
            assert below.count(name) == blocks, name
        assert below.count("resnet") == resnets
        # directly under unet: a transformer's GroupNorm each, the output's
        assert below.count("group_norm") == blocks + 1
    blocks_below = ("self_attention", "cross_attention", "ff")
    for r in recs:
        names, p = [], r
        while p is not None:
            names.append(p.name)
            p = by_id.get(p.parent_id)
        assert names[-1] in ("tokenizer.decode_embedding", "unclip.generate")
        # a transformer block's parts sit directly in their UNet pass and
        # never in one another
        if r.name in blocks_below:
            assert names[1] == "unet", names
        if r.name in blocks_below + ("resnet", "group_norm"):
            assert ("unet" in names) != ("vae" in names), names
        if "unet" in names[1:]:
            assert sum(n in blocks_below for n in names) <= 1, names
        if r.name == "group_norm":
            assert not kids.get(r.span_id)
            assert names[1] in ("unet", "resnet", "vae"), names
        if r.name == "resnet":
            assert names[1] == "unet", names
            assert sorted(c.name for c in kids[r.span_id]) == [
                "group_norm", "group_norm", "linear"]
        if r.name in ("unet", "vae"):
            assert names[1:] == ["unclip.generate"], names
