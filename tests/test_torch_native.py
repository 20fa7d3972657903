"""seed_tpu_torch.native and seed_tpu_torch.data.extract_image_ids against
seed_tpu.native and scripts/extract_image_ids.py, on the CPU.

Contracts: both libraries are built from the same tarloader.cpp, so the
port's index, reads and decodes equal seed_tpu.native's byte for byte; a
failed build leaves ``available()`` False with the compiler's message and
the Python path; ``extract_image_ids.run`` writes the script's records
(``{__key__, image_ids, text, metadata}``, shards ``host0_{n:05d}.tar``,
the tail batch padded) whose ids equal seed_tpu's fp32 encode of the pixels
the chosen loader produced, exactly; the shards read back through
``tar_source`` and build a train_llm caption example.
"""
import io
import tarfile

import numpy as np
import pytest
import torch

from seed_tpu_torch import native as TN
from seed_tpu_torch.data import extract_image_ids as X


def jpeg_bytes(arr):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


def make_tar(path, items):
    with tarfile.open(path, "w") as tf:
        for name, data in items:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


def image_tar(path, n, size=40, seed=0):
    rs = np.random.RandomState(seed)
    items = []
    for i in range(n):
        base = rs.rand(8, 8, 3)
        from PIL import Image
        arr = np.asarray(Image.fromarray((base * 255).astype(np.uint8))
                         .resize((size, size)), np.uint8)
        items.append((f"s{i:03d}.jpg", jpeg_bytes(arr)))
        items.append((f"s{i:03d}.txt", f"caption {i}".encode()))
    make_tar(path, items)


@pytest.fixture(scope="module")
def both():
    from seed_tpu import native as JN
    if not (JN.available() and TN.available()):
        pytest.skip("no g++ / libjpeg here: " + str(TN.build_error()))
    return JN


def test_library_is_built_under_build_not_next_to_its_source(both):
    so = TN.library_path()
    assert so.exists() and so.parent.name == "seed_tpu_torch"
    assert so.parent.parent.name == "build"
    assert not list(TN.SRC.parent.glob("*.so"))


def test_index_and_reads_equal_seed_tpu(both, tmp_path):
    p = str(tmp_path / "a.tar")
    rs = np.random.RandomState(0)
    items = [(f"k{i}.bin", rs.bytes(100 + 37 * i)) for i in range(7)]
    make_tar(p, items)
    idx = TN.tar_index(p)
    assert idx == both.tar_index(p)
    assert [n for n, _, _ in idx] == [n for n, _ in items]
    spans = [(off, sz) for _, off, sz in idx]
    assert TN.tar_read_batch(p, spans) == both.tar_read_batch(p, spans)
    assert TN.tar_read_batch(p, spans) == [d for _, d in items]
    bad = str(tmp_path / "bad.tar")
    open(bad, "wb").write(b"\0" * 1024)
    assert TN.tar_index(bad) == both.tar_index(bad) == []


def test_decode_equals_seed_tpu_and_flags_bad_jpegs(both):
    rs = np.random.RandomState(1)
    jpegs = [jpeg_bytes((rs.rand(48, 64, 3) * 255).astype(np.uint8))
             for _ in range(5)] + [b"not a jpeg"]
    got, ok = TN.jpeg_decode_resize(jpegs, 24, 32, threads=2)
    want, wok = both.jpeg_decode_resize(jpegs, 24, 32, threads=2)
    np.testing.assert_array_equal(ok, wok)
    assert ok[:5].all() and not ok[5]
    # a flagged image's output is never written (np.empty in both)
    np.testing.assert_array_equal(got[ok], want[ok])


def test_fast_image_batches_equal_seed_tpu(both, tmp_path):
    p = str(tmp_path / "imgs.tar")
    image_tar(p, 6)
    got = list(TN.fast_image_batches([p], batch_size=4, image_size=28))
    want = list(both.fast_image_batches([p], batch_size=4, image_size=28))
    assert len(got) == len(want) == 2
    for (gi, gk, gt), (wi, wk, wt) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        assert gk == wk and gt == wt
    assert got[0][2][0] == "caption 0"


def test_failed_build_leaves_the_python_path(tmp_path, monkeypatch):
    """A source g++ refuses: available() is False, the compiler's message is
    kept, tar_index raises seed_tpu's RuntimeError, and the image batches
    come from the Python path."""
    bad = tmp_path / "tarloader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(TN, "SRC", bad)
    monkeypatch.setattr(TN, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(TN, "_lib", None)
    monkeypatch.setattr(TN, "_tried", False)
    monkeypatch.setattr(TN, "_error", None)
    assert not TN.available()
    assert TN.build_error()
    with pytest.raises(RuntimeError, match="unavailable"):
        TN.tar_index(str(bad))
    image_tar(str(tmp_path / "imgs.tar"), 3)
    loader, batches = X.pixel_batches(str(tmp_path / "imgs.tar"), 2, 16)
    try:
        assert loader == "python"
        assert [len(b) for b in batches] == [2, 1]
    finally:
        batches.close()


def test_parse_args_takes_every_flag_of_the_script():
    a = X.parse_args(["--input", "in/*.tar", "--output", "o", "--checkpoint",
                      "ck", "--batch-size", "16", "--image-size", "64",
                      "--shard-size", "5", "--emit-clip-embeds", "--clip-ckpt",
                      "cc", "--device", "cpu"])
    assert (a.input, a.output, a.checkpoint, a.batch_size, a.image_size,
            a.shard_size, a.emit_clip_embeds, a.clip_ckpt, a.device) == (
        "in/*.tar", "o", "ck", 16, 64, 5, True, "cc", "cpu")


@pytest.mark.parametrize("loader", ["native", "python"])
def test_extract_image_ids_run_matches_seed_tpu_encode(tmp_path, monkeypatch,
                                                       loader):
    """11 images, batch 4 (a padded tail of 3), shards of 5: the records of
    the script, ids equal to seed_tpu's fp32 encode of the same pixels; the
    shards read back and build a caption example."""
    import jax
    import jax.numpy as jnp
    from seed_tpu.models import TINY_TOKENIZER, encode, init_seed_tokenizer
    import importlib
    JP = importlib.import_module("seed_tpu.ops.preprocess")
    from seed_tpu_torch import bridge
    from seed_tpu_torch.data import build_caption_example, tar_source
    from seed_tpu_torch.serving.multimodal import ByteTextTokenizer
    if loader == "native" and not TN.available():
        pytest.skip("no g++ / libjpeg here: " + str(TN.build_error()))
    if loader == "python":
        monkeypatch.setattr(TN, "available", lambda: False)
    image_tar(str(tmp_path / "in_0.tar"), 11)
    jparams = init_seed_tokenizer(jax.random.PRNGKey(0), TINY_TOKENIZER)
    params = bridge.from_seed_tpu(jax.tree.map(np.asarray, jparams), "cpu")
    size = 28
    res = X.run(params, TINY_TOKENIZER, str(tmp_path / "in_*.tar"),
                str(tmp_path / "out"), batch_size=4, image_size=size,
                shard_size=5, device="cpu", dtype=torch.float32)
    assert res["images"] == 11 and res["loader"] == loader
    # the warm window: the 7 images of the batches after the first
    assert res["warm_images"] == 7
    assert 0 < res["warm_seconds"] <= res["seconds"]
    assert 0 <= res["warm_wait_s"] <= res["wait_s"]
    names = [p.rsplit("/", 1)[1] for p in res["shards"]]
    assert names == ["host0_00000.tar", "host0_00001.tar", "host0_00002.tar"]

    # the pixels the loader produced, then seed_tpu's encode of them
    _, batches = X.pixel_batches(str(tmp_path / "in_*.tar"), 11, size)
    recs = next(iter(batches))
    batches.close()
    pixels = np.stack([r["pixels"] for r in recs])
    want = np.asarray(encode(jparams, JP.preprocess(
        jnp.asarray(pixels), size, jnp.float32), TINY_TOKENIZER))

    got = sorted(tar_source(str(tmp_path / "out" / "host0_*.tar")),
                 key=lambda r: r["__key__"])
    assert [r["__key__"] for r in got] == [f"s{i:03d}" for i in range(11)]
    assert all(set(r) == {"__key__", "image_ids", "text", "metadata"}
               for r in got)
    assert [r["text"] for r in got] == [f"caption {i}" for i in range(11)]
    np.testing.assert_array_equal(
        np.asarray([r["image_ids"] for r in got]), want)
    ex = build_caption_example(got[0], ByteTextTokenizer(), 96,
                               reverse_ratio=0.0)
    assert ex is not None and len(ex["input_ids"]) == 96
