"""seed_tpu_torch.data against seed_tpu.data on the CPU.

Contract: record order and contents are equal, not close. The same shards
and seed give the same records in the same order through tar_source,
shuffle_buffer, batched and collate (both entry points' streams), the
Prefetcher keeps that order, and every builder gives the same arrays on the
same record with a fresh ``random.Random`` of the same seed on each side.
"""
import io
import pickle
import random
import tarfile
from types import SimpleNamespace

import numpy as np
import pytest

import seed_tpu.data as JD
import seed_tpu_torch.data as TD
from seed_tpu.serving import ByteTextTokenizer as JByteTok
from seed_tpu_torch.serving.multimodal import ByteTextTokenizer as TByteTok
from seed_tpu_torch.train import train_llm, train_tokenizer


def write_pkl_shards(root, n_shards=3, per_shard=24):
    for s in range(n_shards):
        with tarfile.open(root / f"data_{s:03d}.tar", "w") as tf:
            for i in range(per_shard):
                rs = np.random.RandomState(100 * s + i)
                rec = {"image_ids": [int(c) for c in rs.randint(0, 8192, 32)],
                       "text": f"a photo of thing {s}-{i}"}
                if i % 3:
                    rec.update(question=f"what is {s}-{i}?",
                               answer=f"thing {i}")
                if i % 5 == 0:
                    rec["turns"] = [{"question": "hi", "answer": "hello",
                                     "image_ids": rec["image_ids"]},
                                    {"question": "more?", "answer": "no"}]
                data = pickle.dumps(rec)
                info = tarfile.TarInfo(f"s{s}_k{i}.pkl")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    return str(root / "data_*.tar")


def write_img_shards(root, n_shards=2, per_shard=6, size=40):
    from PIL import Image
    for s in range(n_shards):
        with tarfile.open(root / f"img_{s:03d}.tar", "w") as tf:
            for i in range(per_shard):
                arr = np.random.RandomState(10 * s + i).randint(
                    0, 255, (size, size + 8 * i, 3), dtype=np.uint8)
                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, format="JPEG")
                for ext, data in (("jpg", buf.getvalue()),
                                  ("txt", f"caption {s} {i}".encode())):
                    info = tarfile.TarInfo(f"s{s}_k{i}.{ext}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
    return str(root / "img_*.tar")


def assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


# --------------------------------------------------------------- sources

def test_tar_source_records_equal(tmp_path):
    pattern = write_pkl_shards(tmp_path)
    for seed in (0, 7):
        got = list(TD.tar_source(pattern, cycle_count=3, seed=seed))
        want = list(JD.tar_source(pattern, cycle_count=3, seed=seed))
        assert got == want and len(got) == 3 * 72
    # two processes split the shards as seed_tpu's two hosts do
    for h in range(2):
        assert (list(TD.tar_source(pattern, host_index=h, host_count=2))
                == list(JD.tar_source(pattern, host_index=h, host_count=2)))


def test_image_tar_records_equal(tmp_path):
    pattern = write_img_shards(tmp_path)
    for decode in ("decode_image_text", "decode_image_text_lazy"):
        got = list(TD.tar_source(pattern, decode=getattr(TD, decode),
                                 cycle_count=2, seed=3))
        want = list(JD.tar_source(pattern, decode=getattr(JD, decode),
                                  cycle_count=2, seed=3))
        assert [(r["__key__"], r["text"]) for r in got] == \
            [(r["__key__"], r["text"]) for r in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(TD.resize_draft(g["image"], 24)),
                                          np.asarray(JD.resize_draft(w["image"], 24)))


def test_corrupt_tar_and_record_skipped(tmp_path):
    pattern = write_pkl_shards(tmp_path, n_shards=1, per_shard=4)
    (tmp_path / "data_009.tar").write_bytes(b"not a tar at all")
    sample = {"__key__": "bad", "pkl": b"\x80garbage"}
    assert TD.decode_pkl_records(sample) is None
    assert list(TD.tar_source(pattern)) == list(JD.tar_source(pattern))


def test_lmdb_ids_source_dict_lookup(tmp_path):
    store = {f"img{i}.jpg": pickle.dumps(list(range(i, i + 32)))
             for i in range(10) if i % 3}
    meta = tmp_path / "meta.tsv"
    meta.write_text("".join(f"caption {i}\timg{i}.jpg\n" for i in range(10))
                    + "malformed row\n")
    for h, n in ((0, 1), (1, 2)):
        got = list(TD.lmdb_ids_source(str(meta), "", get_fn=store.get,
                                      host_index=h, host_count=n))
        want = list(JD.lmdb_ids_source(str(meta), "", get_fn=store.get,
                                       host_index=h, host_count=n))
        assert got == want and got


def test_combinators_equal():
    files = [f"f{i}" for i in range(7)]
    assert list(TD.cycle(files, 3, seed=5)) == list(JD.cycle(files, 3, seed=5))
    assert (list(TD.pipeline.resampled_shards(files, 2, 50))
            == list(JD.pipeline.resampled_shards(files, 2, 50)))
    assert (list(TD.shuffle_buffer(iter(range(200)), 16, 4))
            == list(JD.shuffle_buffer(iter(range(200)), 16, 4)))
    srcs = lambda: {"a": iter(range(30)), "b": iter(range(100, 110))}
    assert (list(TD.sample_multiplexer(srcs(), {"a": 3.0, "b": 1.0}, 1))
            == list(JD.sample_multiplexer(srcs(), {"a": 3.0, "b": 1.0}, 1)))
    assert (list(TD.multiplexer_longest(srcs()))
            == list(JD.multiplexer_longest(srcs())))
    assert (list(TD.batched(iter(range(23)), 5))
            == list(JD.batched(iter(range(23)), 5)))
    assert TD.shard_for_host(files) == JD.shard_for_host(files, 0, 1)


def test_prefetcher_order_error_and_close():
    stream = [{"x": np.full(3, i)} for i in range(20)]
    got = [b["x"][0] for b in TD.Prefetcher(iter(stream), depth=2)]
    want = [b["x"][0] for b in JD.Prefetcher(iter(stream), depth=2)]
    assert got == want == list(range(20))

    def failing():
        yield 1
        raise KeyError("bad shard")
    it = TD.Prefetcher(failing())
    assert next(it) == 1
    with pytest.raises(KeyError, match="bad shard"):
        next(it)

    endless = TD.Prefetcher(iter(range(10 ** 9)), depth=2)
    assert next(endless) == 0
    endless.close(timeout=10)
    assert not endless._thread.is_alive()


def test_quality_filter_and_clean_caption():
    from PIL import Image
    samples = [{"image": Image.new("RGB", (w, h)), "text": t,
                "meta": {"similarity": s}}
               for w, h, t, s in ((200, 200, "a dog", 0.3),
                                  (100, 300, "a dog", 0.3),
                                  (600, 150, "x " * 600, 0.1),
                                  (300, 200, "", 0.5))]
    for smp in samples:
        for kw in ({}, {"min_similarity": 0.2}):
            assert TD.quality_filter(smp, **kw) == \
                JD.pipeline.quality_filter(smp, **kw)
    for cap in ("A Dog! (running)   fast; ~here.", "word " * 70):
        assert TD.clean_caption(cap) == JD.builders.clean_caption(cap)


# -------------------------------------------------------------- builders

IMG = list(range(32))
BUILDER_CASES = {
    "build_caption_example": (
        {"image_ids": IMG, "text": "a red fox"},
        dict(max_length=128, reverse_ratio=0.5, mask_left_label=True,
             caption_prompts=["Please show me a picture of {}",
                              "Draw {}"]), True),
    "build_conversation_example": (
        [{"question": "what is it", "answer": "a cat", "image_ids": IMG},
         {"question": "sure", "answer": "yes."}], dict(max_length=256), False),
    "build_interleaved_example": (
        {"image_ids": [None, IMG, None, IMG], "texts": ["intro", None, "mid",
                                                        None]},
        dict(max_length=256, reverse_ratio=0.5, max_images=1), True),
    "build_video_example": (
        {"image_ids": list(range(128)), "answer": "a moving cat"},
        dict(max_length=256), False),
    "build_edit_example": (
        {"source_image_ids": IMG, "target_image_ids": IMG[::-1],
         "instruction": "make it red"}, dict(max_length=128), False),
    "build_story_example": (
        {"story": [{"text": "once", "image_ids": IMG},
                   {"text": "then", "image_ids": IMG[1:] + [0]}]},
        dict(max_length=256), False),
    "build_multi_image_qa_example": (
        {"images_ids": [IMG, IMG[::-1]], "question": "difference?",
         "answer": "color"}, dict(max_length=320), False),
    "build_retrieval_augmented_example": (
        {"text": "a red car", "image_ids": IMG,
         "retrieved_texts": ["a blue car", "a fast car", "a third"]},
        dict(max_length=256), True),
    "build_text_conversation_example": (
        {"data": ["hi there", "hello!", "how are you", "fine."]},
        dict(max_length=128, system_message="be nice"), False),
    "build_visual_instruction_example": (
        {"image_ids": [IMG], "data": ["what is this", "a cat", "sure?", "yes"]},
        dict(max_length=256), False),
    "build_multi_edit_example": (
        {"image_ids": IMG * 3, "instruction0": "add a hat",
         "instruction1": "make it red"}, dict(max_length=512), True),
    "build_video_conversation_example": (
        {"image_ids": IMG * 4, "question": "Question: what? Question: why?",
         "answer": "Answer: a thing. Answer: because."},
        dict(max_length=512), False),
}


@pytest.mark.parametrize("name", sorted(BUILDER_CASES))
def test_builder_equal(name):
    """Each builder on the same record: identical arrays (several seeds for
    the builders that draw from ``rng``)."""
    record, kwargs, draws = BUILDER_CASES[name]
    for seed in (range(6) if draws else [0]):
        kw = dict(kwargs, rng=random.Random(seed)) if draws else kwargs
        got = getattr(TD, name)(record, TByteTok(), **kw)
        kw = dict(kwargs, rng=random.Random(seed)) if draws else kwargs
        want = getattr(JD, name)(record, JByteTok(), **kw)
        assert_batches_equal(got, want)
    assert len(BUILDER_CASES) == 12


def test_match_interleaved_images_equal():
    img = np.arange(48, dtype=np.uint8).reshape(4, 4, 3)
    rec = {"text_list": ["s0", "s1", "s2"],
           "image_info": [{"image": img, "matched_text_index": 1,
                           "matched_sim": 0.5},
                          {"image": img + 1, "matched_text_index": 2,
                           "matched_sim": 0.1},
                          {"image": img + 2, "matched_text_index": 0,
                           "matched_sim": 0.9}]}
    for seed in range(4):
        got = TD.match_interleaved_images(rec, rng=random.Random(seed))
        want = JD.builders.match_interleaved_images(rec,
                                                    rng=random.Random(seed))
        assert got["texts"] == want["texts"]
        for g, w in zip(got["images"], want["images"]):
            assert (g is None) == (w is None)
            if g is not None:
                np.testing.assert_array_equal(g, w)
    assert TD.GENERATION_PROMPTS == JD.GENERATION_PROMPTS
    assert TD.image_token_ids(IMG) == JD.image_token_ids(IMG)


# ------------------------------------------------ the entry points' streams

def script_llm_batches(args):
    """scripts/train_llm.py's example and batch streams, on seed_tpu.data."""
    tok = JByteTok()

    def example_stream():
        rng = random.Random(args.seed)
        for rec in JD.tar_source(args.data, cycle_count=None, seed=args.seed):
            if args.mode == "pretrain":
                ex = JD.build_caption_example(rec, tok, args.max_length,
                                              reverse_ratio=0.5, rng=rng)
            else:
                turns = rec.get("turns") or [
                    {"question": rec.get("question", rec.get("text", "")),
                     "answer": rec.get("answer", ""),
                     "image_ids": rec.get("image_ids")}]
                ex = JD.build_conversation_example(turns, tok, args.max_length)
            if ex is not None:
                yield ex

    micro = args.batch_size // args.grad_accum
    base_iter = JD.batched(JD.shuffle_buffer(example_stream(), 4096,
                                             args.seed), micro, JD.collate)
    while True:
        micros = [next(base_iter) for _ in range(args.grad_accum)]
        yield {k: np.stack([m[k] for m in micros]) for k in micros[0]}


@pytest.mark.parametrize("mode", ["pretrain", "sft"])
def test_llm_batch_stream_equal(tmp_path, mode):
    """train_llm's batches (shards -> examples -> shuffle 4096 -> micro
    batches -> [grad_accum, micro, S], through the Prefetcher) equal the
    script's, batch by batch."""
    pattern = write_pkl_shards(tmp_path)
    args = train_llm.parse_args(["--data", pattern, "--mode", mode,
                                 "--batch-size", "6", "--grad-accum", "2",
                                 "--max-length", "96", "--seed", "11"])
    got = TD.Prefetcher(train_llm.batch_stream(args, TByteTok()), depth=2)
    want = script_llm_batches(args)
    for _ in range(8):
        g, w = next(got), next(want)
        assert g["input_ids"].shape == (2, 3, 96)
        assert_batches_equal(g, w)
    got.close()


def test_tokenizer_example_stream_equal(tmp_path):
    """train_tokenizer's image stream (lazy decode -> JPEG draft resize ->
    shuffle buffer -> batches) equals the script's, pixels bit for bit."""
    pattern = write_img_shards(tmp_path)
    args = train_tokenizer.parse_args(["--stage", "1", "--data", pattern,
                                       "--output", str(tmp_path / "o"),
                                       "--image-size", "32"])

    def script_examples():
        for s in JD.tar_source(args.data, decode=JD.decode_image_text_lazy,
                               cycle_count=None, seed=args.seed):
            img = JD.resize_draft(s["image"], args.image_size)
            yield {"pixels": np.asarray(img, np.uint8),
                   "text": s.get("text", ""), "clip_embed": None}

    got = TD.batched(TD.shuffle_buffer(train_tokenizer.example_stream(args),
                                       2000, args.seed), 4)
    want = JD.batched(JD.shuffle_buffer(script_examples(), 2000, args.seed), 4)
    for _ in range(3):
        for g, w in zip(next(got), next(want)):
            assert g["text"] == w["text"]
            np.testing.assert_array_equal(g["pixels"], w["pixels"])


def test_tokenizer_collate_matches_script():
    """Stage-1 collate: the fp32 preprocess of seed_tpu (1e-6: the same
    normalisation) and the same text ids and padding."""
    import importlib
    import jax.numpy as jnp
    JP = importlib.import_module("seed_tpu.ops.preprocess")
    import torch
    args = SimpleNamespace(stage=1, image_size=16, max_text_len=12)
    setup = SimpleNamespace(trainer=SimpleNamespace(device=torch.device("cpu")),
                            clip=None)
    rs = np.random.RandomState(0)
    items = [{"pixels": rs.randint(0, 256, (16, 16, 3)).astype(np.uint8),
              "text": t} for t in ("a cat", "a much longer caption here", "")]
    got = train_tokenizer.make_collate(args, setup, TByteTok())(items)
    want = np.asarray(JP.preprocess(jnp.asarray(np.stack(
        [i["pixels"] for i in items])), 16, jnp.float32))
    np.testing.assert_allclose(got["images"].numpy(), want, atol=1e-6)
    tok = JByteTok()
    for r, it in enumerate(items):
        enc = tok.encode(it["text"])[:12]
        assert got["text_ids"][r, :len(enc)].tolist() == enc
        assert got["text_pad"][r].tolist() == [1] * len(enc) + [0] * (12 - len(enc))
