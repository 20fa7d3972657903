"""The readers of the program's own spans (``device_ms.*``,
``idle_outside_program.tok``) on synthetic span records and a synthetic
profile, and on the card a traced run of ``tok-pretok-b256`` whose split
adds up to the program's device time."""
import time
from types import SimpleNamespace as NS

import pytest
import torch

from h100bench.core import bench
from h100bench.core.trace import DeviceOp, Profile
from seed_tpu_torch.utils import metrics_logging as ML

M = bench.load_manifest()
PARTS = ("preprocess", "vit.linear", "vit.attention", "vit.layer_norm",
         "vit.act", "vit.self", "qformer", "encode.rest")
READERS = ["device_ms." + p for p in PARTS] + ["idle_outside_program.tok"]

# (name, id, parent, host start ns, host end ns, device ms, counts)
TREE = [
    ("tokenizer.encode", 90, None, 10, 50, 40.0, {"images": 256}),  # before
    ("preprocess", 1, None, 100, 200, 0.5, {"images": 2}),
    ("tokenizer.encode", 2, None, 300, 2000, 10.0, {"images": 2}),
    ("vit", 3, 2, 310, 1500, 7.0, {}),
    ("linear", 4, 3, 320, 400, 2.0, {}),
    ("attention", 5, 3, 400, 500, 1.5, {}),
    ("layer_norm", 6, 3, 500, 600, 1.0, {}),
    ("act", 7, 3, 600, 700, 0.5, {}),
    ("linear", 8, 3, 700, 800, 0.5, {}),
    ("layer_norm", 9, 2, 1500, 1600, 0.3, {}),
    ("qformer", 10, 2, 1600, 1900, 1.2, {}),
    ("linear", 11, 10, 1610, 1700, 0.4, {}),
    ("layer_norm", 12, 10, 1700, 1800, 0.2, {}),
    ("linear", 13, 2, 1900, 1950, 0.1, {}),
]
# per image: (device self ms of each part) / 2 images
WANT = {"preprocess": 0.25, "vit.linear": 1.25, "vit.attention": 0.75,
        "vit.layer_norm": 0.5, "vit.act": 0.25, "vit.self": 0.75,
        "qformer": 0.6, "encode.rest": 0.9}


def records(tree=TREE, device=True):
    host, dev = {}, {}
    for name, sid, parent, a, b, ms, _ in tree:
        if parent is not None:
            host[parent] = host.get(parent, 0) + b - a
            dev[parent] = dev.get(parent, 0.0) + ms
    root = {}
    for name, sid, parent, *_ in tree:
        root[sid] = sid if parent is None else root[parent]
    return [ML.SpanRecord(name, sid, parent, root[sid], counts, a, b,
                          b - a - host.get(sid, 0),
                          ms if device else None,
                          ms - dev.get(sid, 0.0) if device else None)
            for name, sid, parent, a, b, ms, counts in tree]


def run_of(recs, monkeypatch):
    monkeypatch.setattr(ML, "recorded_spans", lambda: recs)
    # a 15 ms slice; the benchmark's span from 90 ns
    prof = Profile(0.0, 0.015, [DeviceOp("k", 150, 1000),
                               DeviceOp("k", 1500, 600)],
                   [("encode", 90, 2100)])
    return bench.Run(NS(), [], prof, (0.0, 1.0))


def read(name, run):
    return bench.metric_reader(name)(run)


def test_split_is_a_partition_of_the_slice_device_time(monkeypatch):
    run = run_of(records(), monkeypatch)
    got = {p: read("device_ms." + p, run) for p in PARTS}
    assert got == pytest.approx(WANT)
    # preprocess and tokenizer.encode of the slice: (0.5 + 10.0) / 2
    assert sum(got.values()) == pytest.approx(5.25)
    # the device inside the program 10.5 of the slice's 15 ms
    assert read("idle_outside_program.tok", run) == pytest.approx(30.0)


def test_readers_find_nothing_without_program_spans(monkeypatch):
    run = run_of([], monkeypatch)
    for name in READERS:
        assert read(name, run) is None, name
    # a program without spans at all (the parent commit)
    monkeypatch.delattr(ML, "recorded_spans")
    for name in READERS:
        assert read(name, run) is None, name


def test_host_only_spans_give_no_device_readings(monkeypatch):
    run = run_of(records(device=False), monkeypatch)
    for name in READERS:
        assert read(name, run) is None, name


def test_new_readers_are_in_the_manifest():
    names = {m["name"]: m for m in M["per_layer"]}
    for name in READERS:
        m = names[name]
        assert m["workloads"] == ["tok-pretok-b256"]
        assert m["moves"] == "images_per_s" and m["source"] == "program_span"
        assert m["unit"] == ("%" if name.startswith("idle") else "ms/image")


@pytest.mark.cuda
def test_traced_b256_split_adds_up_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    mix = dict(bench.data("traffic", "pretok-b256"), pool=2)
    ML.clear_spans()
    try:
        out = bench.run_cell(M, "tok-pretok-b256", 2147483659, 3.0, True,
                             time.perf_counter(), mix=mix)
        recs = ML.recorded_spans()
    finally:
        ML.clear_spans()
    got = {n: out["metrics"][n]["value"] for n in READERS}
    assert all(v is not None for v in got.values()), got
    images = sum(r.counts["images"] for r in recs
                 if r.name == "tokenizer.encode")
    assert images == mix["batch"] * mix["profile"]["calls"]
    programs = sum(r.device_ms for r in recs if r.parent_id is None)
    split = sum(got["device_ms." + p] for p in PARTS)
    assert split * images == pytest.approx(programs, rel=1e-6)
    busy = out["device"]["busy_s"] * 1e3 / images
    assert split == pytest.approx(busy, rel=0.03)
    assert 0 <= got["idle_outside_program.tok"] <= \
        out["metrics"]["idle_share.tok"]["value"]
