"""The rest of eval/ of seed_tpu_torch against seed_tpu, on the CPU: the
Inception-v3 network of FID and the Inception Score (on a converted random
torchvision state dict), its two resizes, FID / IS / VQA accuracy, the code
-> image -> features harness, the four eval streams, frame sampling and the
VQA and caption eval loops.

Contracts: Inception features and logits in fp32 within 1e-4 of their
largest magnitude (a hundred convolutions, sums in another order); the
resized pixels within 2e-5, the align-corners resize within 1e-6; FID, IS
and the metrics equal to seed_tpu's to 1e-6 relative (the same numpy);
the streams and loops record for record.
"""
import importlib
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import seed_tpu.eval as JE
from seed_tpu.convert import convert_inception_torch as j_convert_inception
from seed_tpu_torch import bridge
from seed_tpu_torch import eval as TE
from seed_tpu_torch.convert import convert_inception_torch
from seed_tpu_torch.eval import inception as TI
from seed_tpu_torch.utils.tree import leaves_with_path

JI = importlib.import_module("seed_tpu.eval.inception")
JR = importlib.import_module("seed_tpu.eval.eval_readers")

FEAT = 1e-4       # of the largest |feature| / |logit|


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def close_scaled(got, want, tol=FEAT, msg=""):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=tol * scale, err_msg=msg)


def random_state_dict(seed=0):
    """A torchvision-style inception_v3 state dict with random weights, fc
    head included."""
    rs = np.random.RandomState(seed)
    sd = {}
    for name, (cin, cout, k, _, _) in TI.INCEPTION_CONVS.items():
        sd[f"{name}.conv.weight"] = (rs.randn(cout, cin, *k).astype(np.float32)
                                     * (2.0 / (cin * k[0] * k[1])) ** 0.5)
        sd[f"{name}.bn.weight"] = rs.rand(cout).astype(np.float32) + 0.5
        sd[f"{name}.bn.bias"] = rs.randn(cout).astype(np.float32) * 0.1
        sd[f"{name}.bn.running_mean"] = rs.randn(cout).astype(np.float32) * 0.1
        sd[f"{name}.bn.running_var"] = rs.rand(cout).astype(np.float32) + 0.5
    sd["fc.weight"] = rs.randn(1000, 2048).astype(np.float32) * 0.02
    sd["fc.bias"] = rs.randn(1000).astype(np.float32) * 0.01
    return sd


@pytest.fixture(scope="module")
def inception():
    sd = random_state_dict()
    jparams = j_convert_inception(sd)
    tparams = bridge.convs_to_oihw(bridge.from_seed_tpu(
        jax.tree.map(np.asarray, jparams), device="cpu"))
    return sd, jparams, tparams


# -------------------------------------------------------------- Inception

def test_converter_tree_is_the_one_init_inception_makes(inception):
    sd, _, tparams = inception
    converted = convert_inception_torch(sd, device="cpu")
    fresh = TI.init_inception(torch.Generator().manual_seed(0), with_fc=True,
                              device="cpu")
    got = dict(leaves_with_path(converted))
    assert set(got) == {p for p, _ in leaves_with_path(fresh)}
    for path, x in leaves_with_path(fresh):
        assert got[path].shape == x.shape and got[path].dtype == x.dtype, path
        if x.dim() == 4:
            assert got[path].is_contiguous(memory_format=torch.channels_last)
            assert x.is_contiguous(memory_format=torch.channels_last)
    # the bridge carries seed_tpu's converted tree to the same tensors
    for path, x in leaves_with_path(tparams):
        assert torch.equal(got[path], x), path
    assert TI.INCEPTION_CONVS == JI.INCEPTION_CONVS
    assert TI.BN_EPS == JI.BN_EPS


def test_inception_pool3_matches_seed_tpu(inception):
    _, jparams, tparams = inception
    x = np.random.RandomState(1).rand(2, 75, 75, 3).astype(np.float32)
    want = JI.inception_pool3(jparams, jnp.asarray(x), resize_input=False)
    got = TE.inception_pool3(tparams, t(x), resize_input=False)
    assert got.shape == (2, 2048)
    close_scaled(got, want)


def test_inception_logits_and_probs_without_resize(inception):
    _, jparams, tparams = inception
    x = np.random.RandomState(2).rand(2, 75, 75, 3).astype(np.float32) * 2 - 1
    close_scaled(TE.inception_logits(tparams, t(x), resize_input=False),
                 JI.inception_logits(jparams, jnp.asarray(x),
                                     resize_input=False))
    probs = TE.inception_probs(tparams, t(x), resize_input=False)
    want = JI.inception_probs(jparams, jnp.asarray(x), resize_input=False)
    np.testing.assert_allclose(probs.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-6)


@pytest.mark.parametrize("side", [64, 768], ids=["upsample", "downsample"])
def test_inception_logits_resize_matches_seed_tpu(inception, side):
    """The Inception-Score resize is seed_tpu's antialiased
    ``jax.image.resize``: at 768 -> 299 it filters, which the reference's
    nn.Upsample does not (ROADMAP.md section 3); at 64 -> 299 the two agree.
    The align-corners resize of pool3 differs at both sizes."""
    _, jparams, tparams = inception
    x = np.random.RandomState(3).rand(1, side, side, 3).astype(np.float32) * 2 - 1
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 299, 299, 3),
                                       "bilinear"))
    got = TI.resize_bilinear_antialias(t(x), (299, 299))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    assert np.abs(TI.resize_bilinear_align_corners(t(x), (299, 299)).numpy()
                  - want).max() > 1e-3
    close_scaled(TE.inception_logits(tparams, t(x)),
                 JI.inception_logits(jparams, jnp.asarray(x)))


@pytest.mark.parametrize("size", [(299, 299), (40, 33), (1, 9)])
def test_resize_bilinear_align_corners_matches_seed_tpu(size):
    x = np.random.RandomState(4).rand(2, 17, 23, 3).astype(np.float32)
    want = JI.resize_bilinear_align_corners(jnp.asarray(x), size)
    got = TE.resize_bilinear_align_corners(t(x), size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TE.init_inception(torch.Generator(), device="cuda")


def test_eval_exports_every_name_of_seed_tpu():
    assert set(JE.__all__) <= set(TE.__all__)
    assert all(hasattr(TE, n) for n in TE.__all__)


# ---------------------------------------------------------------- metrics

def test_fid_is_and_vqa_accuracy_equal_seed_tpu():
    rs = np.random.RandomState(5)
    real = rs.randn(40, 16)
    fake = rs.randn(36, 16) * 1.3 + 0.2
    assert TE.fid(real, fake) == pytest.approx(JE.fid(real, fake), rel=1e-9)
    assert TE.fid(real, real) == pytest.approx(0.0, abs=1e-6)
    mu, sigma = TE.gaussian_stats(real)
    jmu, jsigma = JE.gaussian_stats(real)
    np.testing.assert_array_equal(mu, jmu)
    np.testing.assert_array_equal(sigma, jsigma)
    # a singular covariance (fewer samples than dims)
    few = rs.randn(5, 16)
    assert TE.fid(few, fake) == pytest.approx(JE.fid(few, fake), rel=1e-9)
    logits = rs.randn(30, 10) * 2
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    for splits in (1, 3, 10):
        assert TE.inception_score(probs, splits) == pytest.approx(
            JE.inception_score(probs, splits), rel=1e-9)
    results = [{"question_id": 1, "answer": "Cat."},
               {"question_id": 2, "answer": "two"},
               {"question_id": 3, "answer": "red"},
               {"image_id": 4, "answer": "no"}]
    ann = {1: ["cat", "cat", "dog"], 2: ["2", "two", "two", "two"],
           3: ["blue"], 4: ["no"]}
    assert TE.vqa_accuracy(results, ann) == JE.vqa_accuracy(results, ann)


def test_generate_images_for_fid_with_stub_fns():
    codes = [np.arange(6).reshape(2, 3) + 10 * i for i in range(3)]
    seen = []

    def decode(c):
        seen.append(c)
        return torch.as_tensor(c, dtype=torch.float32)[..., None].repeat(
            1, 1, 2)

    def features(images):
        return images.mean(-1)

    got = TE.generate_images_for_fid(decode, iter(codes), features,
                                     max_batches=2)
    want = JE.generate_images_for_fid(
        lambda c: np.repeat(np.asarray(c, np.float32)[..., None], 2, -1),
        iter(codes), lambda im: np.asarray(im).mean(-1), max_batches=2)
    np.testing.assert_array_equal(got, want)
    assert all(isinstance(c, np.ndarray) for c in seen) and len(seen) == 2
    # codes that arrive as tensors reach decode as numpy; nothing -> [0, 1]
    got = TE.generate_images_for_fid(decode, [torch.ones(1, 3)], features)
    assert got.shape == (1, 3) and isinstance(seen[-1], np.ndarray)
    assert TE.generate_images_for_fid(decode, [], features).shape == (0, 1)


# ---------------------------------------------------------------- readers

def write_images(root, names, size=20, seed=6):
    rs = np.random.RandomState(seed)
    for n in names:
        Image.fromarray(rs.randint(0, 256, (size, size + 3, 3), np.uint8)
                        ).save(os.path.join(root, n))


def same_records(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if isinstance(w[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k], k


@pytest.fixture
def image_root(tmp_path):
    write_images(tmp_path, ["a.png", "b.png", "c.png", "d.jpg"])
    (tmp_path / "broken.png").write_bytes(b"not an image")
    return tmp_path


def test_caption_and_vqa_streams_equal_seed_tpu(image_root):
    caps = [{"image": "a.png", "caption": ["a cat", "x"], "image_id": 7},
            {"image": "broken.png", "caption": "skipped"},
            {"image": "b.png", "answer": "a dog"},
            {"image": "missing.png", "caption": "skipped"}]
    (image_root / "cap.json").write_text(json.dumps(caps))
    vqa = [{"image": "c.png", "question": "What?", "answer": ["a", "b", "a"],
            "question_id": 3},
           {"image": "d.jpg", "question": "Which", "answer": "left"},
           {"image": "broken.png", "question": "Q", "answer": "x"}]
    (image_root / "vqa.jsonl").write_text(
        "\n".join(json.dumps(r) for r in vqa) + "\n\n")
    for fn, name in ((TE.caption_eval_stream, "cap.json"),
                     (TE.vqa_eval_stream, "vqa.jsonl")):
        jfn = getattr(JR, fn.__name__)
        same_records(fn(str(image_root / name), str(image_root), 32),
                     jfn(str(image_root / name), str(image_root), 32))


def test_edit_stream_equals_seed_tpu(image_root):
    recs = [{"source_image": "a.png", "target_image": "b.png",
             "instruction": "make it blue"},
            {"source_image": "c.png", "target_image": "broken.png",
             "instruction": "skipped"},
            {"source_image": "d.jpg", "target_image": "a.png",
             "instruction": "flip", "sample_id": "s9"}]
    (image_root / "edit.jsonl").write_text(
        "\n".join(json.dumps(r) for r in recs))
    path = str(image_root / "edit.jsonl")
    same_records(TE.edit_eval_stream(path, str(image_root), 24),
                 JR.edit_eval_stream(path, str(image_root), 24))


def test_video_stream_from_frame_dirs_and_npy_equals_seed_tpu(tmp_path):
    frames = tmp_path / "clip0"
    frames.mkdir()
    write_images(frames, [f"{i:03d}.png" for i in range(9)], seed=7)
    stack = np.random.RandomState(8).randint(0, 256, (7, 18, 22, 3), np.uint8)
    np.save(tmp_path / "clip1.npy", stack)
    recs = [{"video": "clip0", "caption": ["people walk"]},
            {"video": "clip1.npy", "question": "what moves",
             "answer": "a car", "sample_id": 5},
            {"video": "clip2.avi", "caption": "no such video"}]
    (tmp_path / "video.json").write_text(json.dumps(recs))
    got = list(TE.video_eval_stream(str(tmp_path / "video.json"),
                                    str(tmp_path), 16, num_frames=4))
    same_records(got, JR.video_eval_stream(str(tmp_path / "video.json"),
                                           str(tmp_path), 16, num_frames=4))
    assert [r["frames"].shape for r in got[:2]] == [(4, 16, 16, 3)] * 2
    for src in ("clip0", "clip1.npy"):
        np.testing.assert_array_equal(
            TE.load_video_frames(str(tmp_path / src), 3, 12, "uniform"),
            JR.load_video_frames(str(tmp_path / src), 3, 12, "uniform"))


@pytest.mark.parametrize("num_frames,vlen", [(4, 9), (8, 5), (3, 30)])
def test_sample_frames_in_all_modes(num_frames, vlen):
    for kw in ({"sample": "uniform"}, {"fix_start": 1},
               {"sample": "rand", "rng": 0}):
        if "rng" in kw:
            got = TE.sample_frames(num_frames, vlen, "rand",
                                   rng=random.Random(3))
            want = JR.sample_frames(num_frames, vlen, "rand",
                                    rng=random.Random(3))
        else:
            got = TE.sample_frames(num_frames, vlen, **kw)
            want = JR.sample_frames(num_frames, vlen, **kw)
        assert got == want and len(got) == min(num_frames, vlen)
    with pytest.raises(NotImplementedError):
        TE.sample_frames(4, 9, "head")


# ------------------------------------------------------------------ loops

def test_evaluate_vqa_equals_seed_tpu():
    recs = [{"question": f"q{i}", "answer": a, "answers": ans,
             "question_id": i}
            for i, (a, ans) in enumerate([("cat", ["cat"]), ("two", None),
                                          ("red", ["red", "blue", "red"]),
                                          ("no", ["no"] * 10)])]
    recs.append({"question": "video", "answer": "walk", "sample_id": "v1"})

    def gen(batch):
        return ["cat", "2", "red", "no", "walk"][:len(batch)] if len(batch) > 2 \
            else ["x"] * len(batch)

    for bs, mb in ((2, None), (4, 1), (16, None)):
        got = TE.evaluate_vqa(gen, iter(recs), batch_size=bs, max_batches=mb)
        want = JR.evaluate_vqa(gen, iter(recs), batch_size=bs, max_batches=mb)
        assert got == want, (bs, mb)


def test_evaluate_captions_equals_seed_tpu():
    stream = [{"input_ids": np.array([[1, 2], [3, 4]]), "image_id": [0, 1]},
              {"input_ids": np.array([[5, 6]]), "image_id": [0]},
              {"input_ids": np.array([[7, 8]]), "image_id": [2]}]
    words = ["a", "cat", "on", "the", "mat", "dog", "red", "sky", "sits"]
    gen = lambda prompts: [[p[0], p[1], p[0] + 1] for p in prompts]
    dec = lambda ids: " ".join(words[i % len(words)] for i in ids)
    ann = {0: ["a cat on the mat"], 1: ["the red dog sits"],
           2: ["a red sky", "the sky"]}
    for mb in (None, 2):
        got = TE.evaluate_captions(gen, dec, iter(stream), ann, mb)
        want = JE.evaluate_captions(gen, dec, iter(stream), ann, mb)
        assert got == pytest.approx(want, rel=1e-12)
