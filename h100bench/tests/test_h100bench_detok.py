"""The de-tokenizer cell ``detok-unclip-b1`` (kind ``unclip``) on the CPU:
its manifest entries, the yardstick's operation counts against torch's
FLOP counter, the split of the program's device operations on synthetic
spans and a synthetic raw profile, the other readers, and whole runs at a
tiny size, sound and with the timed path broken underneath (``correct``
true for the first, false for each fault)."""
import time
from types import SimpleNamespace as NS

import pytest
import torch
from torch.autograd import DeviceType

from h100bench.core import bench, work_unclip as W
from h100bench.core.trace import DeviceOp, Profile, Span
from h100bench.metrics import _detok_split as DS
from seed_tpu_torch.utils import metrics_logging as ML

M = bench.load_manifest()
CELL = "detok-unclip-b1"
SPEC = bench.data("configs", "sd21-unclip-bf16")
KIND = bench.kind_module("unclip")
PARTS = DS.PARTS
NEW = ["device_ms." + p for p in PARTS] + [
    "mfu.detok", "unet_attention_roofline", "launches_per_unet_pass"]


def tiny():
    """The configuration at a CPU size with every structural trigger: a
    level without attention, a skip concatenation of unequal widths, heads
    of 32, the projection class embedding, a VAE with an upsample."""
    cfg = bench.data("configs", "sd21-unclip-bf16")
    cfg["unet"].update(sample_size=8, block_out_channels=[32, 64],
                       layers_per_block=1,
                       down_block_types=["CrossAttnDownBlock2D", "DownBlock2D"],
                       up_block_types=["UpBlock2D", "CrossAttnUpBlock2D"],
                       attention_head_dim=[1, 2], cross_attention_dim=64,
                       norm_num_groups=4,
                       projection_class_embeddings_input_dim=32)
    cfg["vae"].update(block_out_channels=[8, 16], layers_per_block=1,
                      norm_num_groups=4)
    # the converter's empty prompt takes heads of 64: one head of 64 here
    cfg["text_encoder"].update(vocab_size=64, hidden_size=64,
                               num_hidden_layers=1, num_attention_heads=1,
                               intermediate_size=64, max_position_embeddings=8)
    cfg["tokenizer"].update(codebook_size=64, code_dim=8, query_len=8,
                            hidden=32, decode_depth=2, decode_heads=2,
                            image_embed_dim=16)
    return cfg, dict(bench.data("traffic", "detok-b1"), pool=3)


# --------------------------------- manifest ----------------------------------

def test_manifest_entries():
    cfgs = {c["name"]: c for c in M["configs"]}
    assert cfgs["sd21-unclip-bf16"]["reduced"] == []
    assert SPEC["reduced"] == {} and SPEC["kind"] == "unclip"
    w = bench.workload(M, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (
        "sd21-unclip-bf16", "detok-b1", 1)
    e2e = [m["name"] for m in bench.metrics_for(M, "end_to_end", CELL)]
    assert e2e == ["images_per_s", "setup_s"]
    layer = [m for m in M["per_layer"] if CELL in m.get("workloads", ())]
    assert [m["name"] for m in layer] == NEW
    for m in layer:
        assert m["workloads"] == [CELL] and m["moves"] == "images_per_s"
        assert m["layer"] == {"unet_attention_roofline": "kernels",
                              "launches_per_unet_pass": "host launches"
                              }.get(m["name"], "model step")


def test_published_sizes():
    u, v = SPEC["unet"], SPEC["vae"]
    assert u["block_out_channels"] == [320, 640, 1280, 1280]
    assert [c // h for c, h in zip(u["block_out_channels"],
                                   u["attention_head_dim"])] == [64] * 4
    assert (u["sample_size"] * 8, v["scaling_factor"]) == (768, 0.18215)
    assert SPEC["pipeline"]["num_inference_steps"] == 20
    assert SPEC["pipeline"]["guidance_scale"] == 10.0


# ------------------------------- the yardstick -------------------------------

def test_counts_at_the_published_sizes():
    """One UNet pass at the CFG batch of two is 4,298.2 GFLOP, the count of
    torch's FLOP counter over the port's pass on the card."""
    assert W.unet_flops(SPEC, 2) / 1e9 == pytest.approx(4298.2285312)
    shapes = W.self_attention_shapes(SPEC, 2)
    assert len(shapes) == 16
    assert shapes.count((2, 9216, 320)) == 5
    assert W.detok_flops(SPEC) == pytest.approx(
        W.decode_embedding_flops(SPEC, 1) + 20 * W.unet_flops(SPEC, 2)
        + W.vae_flops(SPEC, 1))


def test_counts_match_torch_flop_counter_at_a_tiny_size():
    from torch.utils.flop_counter import FlopCounterMode
    from seed_tpu_torch.models import seed_tokenizer as ST
    from seed_tpu_torch.models.unclip import unet_apply, vae_decode
    cfg, _ = tiny()
    w = KIND.make_weights(cfg, 3, "cpu", torch.float32)
    tok_cfg, ucfg = KIND.program_config(cfg)
    s = cfg["unet"]["sample_size"]
    x = torch.randn(2, s, s, 4)
    ctx = w["unclip"]["empty_prompt_embeds"].expand(2, -1, -1)
    labels = torch.randn(2, cfg["unet"]["projection_class_embeddings_input_dim"])
    codes = torch.randint(0, 64, (1, 8))
    for fn, want in (
            (lambda: unet_apply(w["unclip"]["unet"], x, torch.tensor([1, 2]),
                                ctx, labels, ucfg.unet), W.unet_flops(cfg, 2)),
            (lambda: vae_decode(w["unclip"]["vae"], x[:1], ucfg.vae),
             W.vae_flops(cfg, 1)),
            (lambda: ST.decode_embedding(w["tokenizer"], codes, tok_cfg),
             W.decode_embedding_flops(cfg, 1))):
        with FlopCounterMode(display=False) as fc:
            fn()
        assert fc.get_total_flops() == want


# --------------------------- the split of the spans --------------------------

# (name, id, parent, host start ns, host end ns, counts)
TREE = [
    ("tokenizer.decode_embedding", 1, None, 100, 200, {"images": 2}),
    ("linear", 2, 1, 110, 150, {}),
    ("unclip.generate", 3, None, 300, 2000, {"images": 2, "steps": 20}),
    ("unet", 4, 3, 310, 1500, {}),
    ("resnet", 5, 4, 320, 400, {}),
    ("group_norm", 6, 5, 330, 350, {}),
    ("linear", 7, 5, 360, 370, {}),
    ("group_norm", 8, 4, 400, 420, {}),
    ("self_attention", 9, 4, 500, 600, {}),
    ("linear", 10, 9, 510, 520, {}),
    ("cross_attention", 11, 4, 600, 700, {}),
    ("layer_norm", 12, 4, 700, 710, {}),
    ("ff", 13, 4, 710, 800, {}),
    ("vae", 14, 3, 1600, 1900, {}),
    ("group_norm", 15, 14, 1610, 1700, {}),
]
# (host launch ns, device ns): the launching span, then the part
LAUNCHES = [
    (90, 7000),        # outside every span: the codes' copy
    (120, 1000),       # linear under decode_embedding: detok.embed
    (160, 500),        # decode_embedding itself
    (305, 300),        # unclip.generate: detok.rest
    (315, 200),        # unet: unet.rest
    (325, 400),        # resnet: unet.resnet
    (340, 600),        # group_norm under resnet: unet.group_norm
    (365, 100),        # linear under resnet: unet.resnet
    (410, 700),        # group_norm under unet: unet.group_norm
    (515, 5000),       # linear under self_attention
    (550, 3000),       # self_attention
    (650, 900),        # cross_attention
    (705, 80),         # layer_norm: unet.rest
    (750, 1100),       # ff
    (1550, 40),        # unclip.generate between unet and vae: detok.rest
    (1650, 2000),      # group_norm under vae: vae
    (1800, 1500),      # vae
    (1950, 60),        # the host copy: detok.rest
]
WANT_NS = {"detok.embed": 1500, "detok.rest": 400, "unet.rest": 280,
           "unet.resnet": 500, "unet.group_norm": 1300,
           "unet.self_attention": 8000, "unet.cross_attention": 900,
           "unet.ff": 1100, "vae": 3500}


def records(tree=TREE):
    root = {}
    for name, sid, parent, *_ in tree:
        root[sid] = sid if parent is None else root[parent]
    return [ML.SpanRecord(name, sid, parent, root[sid], counts, a, b, 0,
                          None, None)
            for name, sid, parent, a, b, counts in tree]


class _Event:
    def __init__(self, name, device, start, dur, corr, link):
        self._v = (name, device, start, dur, corr, link)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def activity_type(self):
        return "kernel" if self._v[1] == DeviceType.CUDA else "cpu_op"


def raw_profile(launches=LAUNCHES):
    """Host ops with correlation ids, each launching one kernel linked to
    it, and a kernel the profiler could not link (left out)."""
    ev = []
    for i, (t, dur) in enumerate(launches, start=1):
        ev.append(_Event("aten::op", DeviceType.CPU, t, 5, i, 0))
        ev.append(_Event("kernel", DeviceType.CUDA, 10_000 + 10 * i, dur,
                         100 + i, i))
    ev.append(_Event("kernel", DeviceType.CUDA, 50, 999, 999, 12345))
    return NS(profiler=NS(kineto_results=NS(events=lambda: ev)))


def run_of(recs, monkeypatch, prof=None, batch=1):
    monkeypatch.setattr(ML, "recorded_spans", lambda: recs)
    ops = [DeviceOp("k", 80, 10), DeviceOp("k", 2000, 100)]
    profile = Profile(0.0, 0.01, ops, [("decode", 85, 2100)])
    cell = NS(spec=SPEC, batch=batch,
              profiled=raw_profile() if prof is None else prof)
    return bench.Run(cell, [], profile, (0.0, 1.0))


def read(name, run):
    return bench.metric_reader(name)(run)


def test_split_is_a_partition_of_the_roots_device_operations(monkeypatch):
    run = run_of(records(), monkeypatch)
    got = {p: read("device_ms." + p, run) for p in PARTS}
    want = {p: ns / 1e6 / 2 for p, ns in WANT_NS.items()}
    assert got == pytest.approx(want)
    # every operation launched inside a root, over the two images
    inside = sum(d for t, d in LAUNCHES if 100 <= t <= 200 or 300 <= t <= 2000)
    assert sum(got.values()) == pytest.approx(inside / 1e6 / 2)


def test_innermost_takes_the_deepest_open_span():
    recs = records()
    got = DS.innermost(recs, [90, 120, 160, 340, 365, 1650, 1950])
    assert [None if r is None else r.span_id for r in got] == [
        None, 2, 1, 6, 7, 15, 3]


def test_readers_find_nothing_without_program_spans(monkeypatch):
    run = run_of([], monkeypatch)
    for name in NEW[:-3] + ["unet_attention_roofline",
                            "launches_per_unet_pass"]:
        assert read(name, run) is None, name
    # spans, but no device operation linked to a launch
    run = run_of(records(), monkeypatch, NS(profiler=NS(
        kineto_results=NS(events=lambda: []))))
    for name in NEW[:-3] + ["unet_attention_roofline"]:
        assert read(name, run) is None, name
    # an untraced run keeps no raw profile
    run = run_of(records(), monkeypatch)
    run.cell.profiled = None
    assert read("device_ms.unet.ff", run) is None
    # a program without spans at all (the parent commit)
    run = run_of([], monkeypatch)
    monkeypatch.delattr(ML, "recorded_spans")
    for name in NEW:
        if name != "mfu.detok":     # the benchmark's own spans
            assert read(name, run) is None, name


def test_roofline_and_launches(monkeypatch):
    recs = records(TREE + [("unet", 16, 3, 1510, 1590, {})])
    run = run_of(recs, monkeypatch)
    need = 2 * sum(max(f / 989e12, b / 3.35e12) for f, b in (
        W.self_attention_work(*s) for s in W.self_attention_shapes(SPEC, 2)))
    assert read("unet_attention_roofline", run) == pytest.approx(
        100 * need / 8000e-9)
    assert read("launches_per_unet_pass", run) == 1.0


def test_mfu_over_unprofiled_calls():
    spans = [Span("decode", 1.0, 3.0, {"images": 1}),
             Span("decode", 3.0, 5.0, {"images": 1}),
             Span("decode", 6.0, 9.0, {"images": 1})]
    prof = Profile(5.5, 9.5, [DeviceOp("k", 0, 10)], [])
    run = bench.Run(NS(spec=SPEC), spans, prof, (0.0, 10.0))
    assert read("mfu.detok", run) == pytest.approx(
        100 * 2 * W.detok_flops(SPEC) / (4.0 * 989e12))


# ------------------------------ whole runs -----------------------------------

def run(patch=None, seconds=1.0):
    cfg, mix = tiny()
    return bench.run_cell(M, CELL, 2147483777, seconds, False,
                          time.perf_counter(), device="cpu", config=cfg,
                          mix=mix, patch=patch)


def test_sound_run_is_correct():
    r = run()
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["checks"]) == set(KIND.CHECKS)


def _self_attention_skipped(monkeypatch):
    import seed_tpu_torch.models.unclip.unet as U
    inner = U.attention_apply

    def skipped(p, x, ctx, heads):
        return torch.zeros_like(x) if ctx is x else inner(p, x, ctx, heads)

    monkeypatch.setattr(U, "attention_apply", skipped)


def _vae_returns_latents(monkeypatch):
    import seed_tpu_torch.models.unclip.pipeline as P
    monkeypatch.setattr(P, "vae_decode", lambda params, z, cfg: (
        z[..., :3].repeat_interleave(cfg.upscale, 1)
        .repeat_interleave(cfg.upscale, 2)))


def _step_returns_sample(monkeypatch):
    from seed_tpu_torch.models.unclip.schedulers import DDIMScheduler
    monkeypatch.setattr(DDIMScheduler, "step",
                        lambda self, out, sample, a_t, a_prev: sample.float())


def _alpha_prev_one_step_late(monkeypatch):
    from seed_tpu_torch.models.unclip.schedulers import DDIMScheduler
    tables = DDIMScheduler.make_tables

    def late(self, steps, device="cuda"):
        ts, a_t, a_prev = tables(self, steps, device)
        return ts, a_t, torch.cat([a_prev[1:], a_prev[-1:]])

    monkeypatch.setattr(DDIMScheduler, "make_tables", late)


def _prompt_padded_with_eos(monkeypatch):
    import seed_tpu_torch.convert.__main__ as C
    monkeypatch.setattr(C, "CLIP_PAD", C.CLIP_EOS)


def _set(attr, value):
    return lambda cell: setattr(cell.service.diffusion, attr, value)


def _codes_off_by_one(cell):
    inner = cell.call
    n = cell.config["tokenizer"]["codebook_size"]
    cell.call = lambda codes: inner((codes + 1) % n)


@pytest.mark.parametrize("fault", ["self_attention", "guidance", "steps",
                                   "vae", "codes", "step_returns_sample",
                                   "alpha_prev_late", "prompt_padding"])
def test_faults_are_not_correct(fault, monkeypatch):
    patch = None
    if fault == "self_attention":
        _self_attention_skipped(monkeypatch)
    elif fault == "vae":
        _vae_returns_latents(monkeypatch)
    elif fault == "step_returns_sample":
        _step_returns_sample(monkeypatch)
    elif fault == "alpha_prev_late":
        _alpha_prev_one_step_late(monkeypatch)
    elif fault == "prompt_padding":
        _prompt_padded_with_eos(monkeypatch)
    elif fault == "guidance":
        patch = _set("guidance_scale", 1.0)
    elif fault == "steps":
        patch = _set("num_inference_steps", 19)
    else:
        patch = _codes_off_by_one
    r = run(patch)
    assert not r["correct"], (fault, r["checks"])


def test_control_reads_above_the_program():
    cfg, mix = tiny()
    row = bench.readings(M, CELL, 2147483939, 1.0, mix=mix, config=cfg,
                         control=True, device="cpu")
    for k in KIND.CHECKS:
        assert row["control"][k] > row["checks"][k], (k, row)
