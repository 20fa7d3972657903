"""The HTTP service of seed_tpu_torch on the CPU: GenerateService against
seed_tpu's on bridged weights (greedy decoding forced through a test
GenerationConfig), the serving image transform, the HTTP round trip, the
vote log, conversation state, the device-side transforms and the host
offload.
"""
import base64
import dataclasses
import importlib
import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from seed_tpu.models import llama as JM
from seed_tpu.models import seed_tokenizer as JST
from seed_tpu.serving import conversation as JC
from seed_tpu.serving import engine as JE
from seed_tpu.serving import multimodal as JMM
from seed_tpu.serving import server as JSRV
from seed_tpu_torch import BOI_TOKEN_ID, EOI_TOKEN_ID, IMAGE_ID_SHIFT, IMG_FLAG
from seed_tpu_torch import bridge
from seed_tpu_torch.models import llama as TM
from seed_tpu_torch.models import seed_tokenizer as TST
from seed_tpu_torch.ops import preprocess as TP
from seed_tpu_torch.serving import conversation as TC
from seed_tpu_torch.serving import engine as TE
from seed_tpu_torch.serving import multimodal as TMM
from seed_tpu_torch.serving import server as TSRV
from seed_tpu_torch.serving.offload import (OffloadedParams, ResidentParams,
                                            wrap_params)
from seed_tpu_torch.serving.scheduler import ScheduledEngine

JP = importlib.import_module("seed_tpu.ops.preprocess")   # not the function


def bridged(tree):
    return bridge.from_seed_tpu(jax.tree.map(np.asarray, tree), device="cpu")


def png_b64(arr: np.ndarray) -> str:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


@pytest.fixture(scope="module")
def services():
    """The same tiny LLaMA and tokenizer (32 queries, so an image block
    decodes) behind both packages' GenerateService."""
    jp = JM.init_llama(jax.random.PRNGKey(0), JM.TINY_LLAMA, jnp.float32)
    jcfg, tcfg = (dataclasses.replace(c, qformer=dataclasses.replace(
        c.qformer, query_len=32)) for c in (JST.TINY_TOKENIZER,
                                            TST.TINY_TOKENIZER))
    jtok = JST.init_seed_tokenizer(jax.random.PRNGKey(1), jcfg)
    jeng = JE.LlamaEngine(jp, JM.TINY_LLAMA, max_len=128,
                          cache_dtype=jnp.float32)
    teng = TE.LlamaEngine(bridged(jp), TM.TINY_LLAMA, max_len=128,
                          cache_dtype=torch.float32, device="cpu")
    jsvc = JSRV.GenerateService(JMM.SeedLlamaInterface(jeng, jtok, jcfg),
                                image_size=jcfg.vit.image_size)
    tsvc = TSRV.GenerateService(
        TMM.SeedLlamaInterface(teng, bridged(jtok), tcfg, device="cpu"),
        image_size=tcfg.vit.image_size)
    return jsvc, tsvc


@pytest.fixture
def greedy(monkeypatch):
    """Both services build their GenerationConfig with do_sample=True; the
    draws of the two packages differ by design, so the comparison forces
    greedy decoding through the config both modules construct."""
    monkeypatch.setattr(JSRV, "GenerationConfig", lambda **kw: JE.GenerationConfig(
        **{**kw, "do_sample": False}))
    monkeypatch.setattr(TSRV, "GenerationConfig", lambda **kw: TE.GenerationConfig(
        **{**kw, "do_sample": False}))


CODES = [(7 * i + 3) % 64 for i in range(32)]
REQUESTS = [
    {"text": "hi there", "max_new_tokens": 6},
    {"text": f"what is {IMG_FLAG}?", "images": [CODES], "max_new_tokens": 6},
    {"text": f"{IMG_FLAG} and {IMG_FLAG}", "images": [CODES, CODES[::-1]],
     "max_new_tokens": 5, "temperature": 0.3, "top_p": 0.9},
    {"text": "draw a cat", "force_boi": True, "max_new_tokens": 8},
    {"text": f"a {IMG_FLAG} b", "images": []},
]


@pytest.mark.parametrize("req", REQUESTS, ids=["text", "cached_ids", "two_images",
                                               "force_boi", "mismatch"])
def test_generate_equals_seed_tpu(services, greedy, req):
    """The same request through both services: text, images_ids and
    error_msg equal; images are empty strings (no diffusion model)."""
    jsvc, tsvc = services
    want, got = jsvc.generate(dict(req)), tsvc.generate(dict(req))
    assert set(got) == {"text", "images", "images_ids", "error_msg"}
    assert got["text"] == want["text"]
    assert got["images_ids"] == want["images_ids"]
    assert got["error_msg"] == want["error_msg"]
    assert got["images"] == want["images"]
    assert all(img == "" for img in got["images"])
    if req.get("images") == []:
        assert got["error_msg"] and got["text"] == ""


def test_generated_image_block_is_validated(services):
    """A well-formed generated block comes back as IMG_FLAG in the text with
    its ids in images_ids and an empty image string; a malformed one and an
    unpaired BOI are reported in error_msg."""
    _, tsvc = services
    good = [BOI_TOKEN_ID] + [c + IMAGE_ID_SHIFT for c in CODES] + [EOI_TOKEN_ID]
    short = [BOI_TOKEN_ID, 5 + IMAGE_ID_SHIFT, EOI_TOKEN_ID]
    stream = [72 + 3] + good + [105 + 3] + short + [BOI_TOKEN_ID]

    class Canned:
        def generate(self, prompts, gen, seed=0):
            self.gen = gen
            return [list(stream)]
    engine, tsvc.iface.engine = tsvc.iface.engine, Canned()
    try:
        resp = tsvc.generate({"text": "x", "force_boi": True})
        assert tsvc.iface.engine.gen.forced_first_token == BOI_TOKEN_ID
        assert tsvc.iface.engine.gen.do_sample
    finally:
        tsvc.iface.engine = engine
    assert resp["text"] == f"H{IMG_FLAG}i{IMG_FLAG}"
    assert resp["images"] == ["", ""] and resp["images_ids"] == [CODES]
    assert len(resp["error_msg"]) == 2
    assert "BOI tokens: 3 != EOI tokens: 2" in resp["error_msg"][0]
    assert "len(image_ids) 1 != 32" in resp["error_msg"][1]


@pytest.mark.parametrize("keep_ratio", [False, True])
@pytest.mark.parametrize("shape", [(84, 56), (57, 91), (28, 28), (31, 28)])
def test_prepare_image_equals_seed_tpu(services, keep_ratio, shape):
    """_prepare_image, both keep_ratio branches: byte for byte the same
    uint8 pixels as seed_tpu's (PIL does the resampling in both)."""
    jsvc, tsvc = services
    raw = np.random.RandomState(sum(shape)).randint(0, 256, (*shape, 3),
                                                    dtype=np.uint8)
    j = JSRV.GenerateService(jsvc.iface, jsvc.image_size, keep_ratio)
    t = TSRV.GenerateService(tsvc.iface, tsvc.image_size, keep_ratio)
    want = j._prepare_image(Image.fromarray(raw))
    got = t._prepare_image(Image.fromarray(raw))
    assert got.dtype == np.uint8 and got.shape == (28, 28, 3)
    np.testing.assert_array_equal(got, want)


def test_encode_images_mixes_pixels_and_cached_ids(services):
    """base64 uploads are prepared, encoded in one batch and interleaved
    with cached ids in request order; the ids equal the direct encode of
    the prepared pixels."""
    _, tsvc = services
    rs = np.random.RandomState(3)
    a = rs.randint(0, 256, (56, 84, 3), dtype=np.uint8)
    b = rs.randint(0, 256, (28, 28, 3), dtype=np.uint8)
    out = tsvc._encode_images([png_b64(a), CODES, png_b64(b)])
    assert out[1] == CODES and all(len(o) == 32 for o in out)
    pixels = np.stack([tsvc._prepare_image(Image.fromarray(x)) for x in (a, b)])
    want = tsvc.iface.encode_image(TP.preprocess(torch.from_numpy(pixels), 28,
                                                 torch.float32))
    assert [out[0], out[2]] == want.tolist()


def post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


@pytest.fixture
def http(services, tmp_path):
    server = TSRV.make_server(services[1], host="127.0.0.1", port=0,
                              log_dir=str(tmp_path))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server.server_address[1], tmp_path
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def test_http_roundtrip(http):
    port, _ = http
    raw = np.random.RandomState(5).randint(0, 256, (40, 60, 3), dtype=np.uint8)
    status, body = post(port, "/generate", {
        "text": f"see {IMG_FLAG}", "images": [png_b64(raw)],
        "max_new_tokens": 4})
    assert status == 200
    assert set(body) == {"text", "images", "images_ids", "error_msg"}
    assert len(body["images_ids"]) >= 1 and len(body["images_ids"][0]) == 32
    # a mismatched <image> count is an error message, not a 500
    status, body = post(port, "/generate", {"text": f"a {IMG_FLAG}", "images": []})
    assert status == 200 and body["error_msg"] and body["text"] == ""
    # a request the service cannot parse is a 500 with the same contract
    with pytest.raises(urllib.error.HTTPError) as err:
        post(port, "/generate", {"images": []})
    assert err.value.code == 500
    assert set(json.loads(err.value.read())) == {"text", "images",
                                                 "images_ids", "error_msg"}
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=30) as r:
        page = r.read().decode()
    assert r.status == 200 and "/generate" in page and "<html>" in page
    with pytest.raises(urllib.error.HTTPError) as err:
        post(port, "/nothing", {})
    assert err.value.code == 404


def test_vote_route_logs_jsonl(http):
    port, log_dir = http
    status, body = post(port, "/vote", {"type": "upvote",
                                        "state": {"messages": ["hi"]}})
    assert status == 200 and body["ok"]
    logs = list(log_dir.glob("*-conv.json"))
    assert len(logs) == 1
    rec = json.loads(logs[0].read_text().strip())
    assert rec["type"] == "upvote" and rec["state"] == {"messages": ["hi"]}
    assert "tstamp" in rec and "ip" in rec
    TSRV.record_vote(str(log_dir), "downvote", None, ip="x")
    assert len(logs[0].read_text().strip().splitlines()) == 2


def test_b64_helpers_roundtrip():
    img = np.random.RandomState(0).rand(8, 8, 3).astype(np.float32)
    b64 = TSRV.encode_image_b64(img)
    assert b64 == JSRV.encode_image_b64(img)
    back = np.asarray(TSRV.decode_image_b64(b64), np.float32) / 255.0
    assert np.abs(back - img).max() <= 1 / 255.0


def test_scheduled_engine_behind_the_service(services):
    """--scheduler: the service on a ScheduledEngine, concurrent requests,
    greedy streams equal to the LlamaEngine's."""
    _, tsvc = services
    params, cfg = tsvc.iface.engine.params, tsvc.iface.engine.cfg
    se = ScheduledEngine(params, cfg, slots=2, max_len=128, decode_chunk=4,
                         cache_dtype=torch.float32, device="cpu")
    svc = TSRV.GenerateService(
        TMM.SeedLlamaInterface(se, tsvc.iface.tok_params, tsvc.iface.tok_cfg,
                               device="cpu"), image_size=28)
    prompt = [1] + svc.iface.text.encode("hi there")
    gen = TE.GenerationConfig(max_new_tokens=5, do_sample=False)
    want = tsvc.iface.engine.generate([prompt], gen)[0]
    out = [None] * 3

    def call(i):
        out[i] = svc.generate({"text": "hi there", "max_new_tokens": 5,
                               "temperature": 0.0})
    try:
        threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        se.close()
    assert all(o["text"] == svc.iface.text.decode(want) for o in out)


def test_main_flags_and_build_service(monkeypatch):
    """main() takes scripts/serve.py's flags plus --w8a8-encoder and hands
    the built service to serve()."""
    seen = {}
    monkeypatch.setattr(TSRV, "build_service", lambda args: seen.update(
        vars(args)) or "svc")
    monkeypatch.setattr(TSRV, "serve", lambda svc, host, port: seen.update(
        svc=svc, served=(host, port)))
    TSRV.main(["--model", "8b", "--scheduler", "--slots", "16",
               "--decode-chunk", "4", "--slot-cache", "fp8", "--offload",
               "--keep-ratio", "--host", "127.0.0.1", "--port", "0",
               "--w8a8-encoder"])
    assert seen["svc"] == "svc" and seen["served"] == ("127.0.0.1", 0)
    assert (seen["model"], seen["slots"], seen["decode_chunk"]) == ("8b", 16, 4)
    assert seen["slot_cache"] == "fp8" and seen["device"] == "cuda"
    assert all(seen[k] for k in ("scheduler", "offload", "keep_ratio",
                                 "w8a8_encoder"))


# ------------------------------ conversation --------------------------------

@pytest.mark.parametrize("style", ["SINGLE", "LLAMA_2"])
def test_conversation_equals_seed_tpu(style):
    def talk(mod):
        conv = mod.Conversation(system="be nice",
                                sep_style=getattr(mod.SeparatorStyle, style))
        conv.append("USER", f"look {IMG_FLAG}", images=["B64"])
        first = conv.get_prompt()
        conv.update_image_ids([CODES])
        conv.add_response({"text": f"here {IMG_FLAG}", "images": [""],
                           "images_ids": [CODES, CODES[::-1]]})
        conv.append("USER", "thanks")
        return first, conv.get_prompt(), conv.copy().messages[1].images_ids
    assert talk(TC) == talk(JC)
    assert TC.CONV_SEED_LLAMA.get_prompt() == JC.CONV_SEED_LLAMA.get_prompt()
    with pytest.raises(AssertionError):
        TC.CONV_LLAMA_2.copy().append("USER", "no flag", images=["B64"])


# --------------------------- device-side transforms -------------------------

def test_torchvision_size_math_equals_seed_tpu():
    for h, w in [(84, 56), (57, 91), (28, 28), (31, 28), (100, 27), (29, 35)]:
        assert (TP.torchvision_resize_size(h, w, 28)
                == JP.torchvision_resize_size(h, w, 28))
    for h, w in [(35, 28), (28, 35), (33, 40), (28, 28)]:
        assert TP.torchvision_crop_box(h, w, 28) == JP.torchvision_crop_box(h, w, 28)


@pytest.mark.parametrize("shape", [(84, 57), (40, 91), (28, 28)])
def test_center_crop_resize_pil_equals_seed_tpu_and_server(services, shape):
    """The device transform of the keep_ratio branch: the normalized pixels
    equal seed_tpu's to 1e-6 (the uint8 resize is bit-exact), and the uint8
    stage equals what the server's host path prepares."""
    raw = np.random.RandomState(shape[0]).randint(0, 256, (2, *shape, 3),
                                                  dtype=np.uint8)
    want = JP.center_crop_resize_pil(jnp.asarray(raw), 28, dtype=jnp.float32)
    got = TP.center_crop_resize_pil(torch.from_numpy(raw), 28,
                                    dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    svc = TSRV.GenerateService(services[1].iface, 28, keep_ratio=True)
    host = np.stack([svc._prepare_image(Image.fromarray(r)) for r in raw])
    np.testing.assert_allclose(
        got.numpy(), TP.normalize(torch.from_numpy(host).float() / 255.0).numpy(),
        atol=1e-6)


def test_center_crop_resize_equals_seed_tpu():
    """The continuous-bicubic variant: 2e-5 (fp32 sums of the resize)."""
    raw = np.random.RandomState(1).randint(0, 256, (2, 40, 61, 3), dtype=np.uint8)
    want = JP.center_crop_resize(jnp.asarray(raw), 28, dtype=jnp.float32)
    got = TP.center_crop_resize(torch.from_numpy(raw), 28, dtype=torch.float32)
    assert got.shape == (2, 28, 28, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


# -------------------------------- offload -----------------------------------

class TestOffload:
    def setup_method(self):
        self.params = {"w": torch.ones(4, 4), "b": [torch.zeros(2)]}

    def test_acquire_release_round_trip(self):
        off = OffloadedParams(self.params, device="cpu")
        assert not off.resident and off.swap_count == 0
        with off as p:
            assert off.resident and off.swap_count == 1
            assert torch.equal(p["w"], torch.ones(4, 4))
            with off as again:
                assert again is p                  # one shared copy
            assert off.resident and off.swap_count == 1
        assert not off.resident
        with off:
            assert off.swap_count == 2             # streamed in again
        assert torch.equal(off.params["w"], torch.ones(4, 4))
        assert off.nbytes == 16 * 4 + 2 * 4

    def test_resident_and_wrap(self):
        res = ResidentParams(self.params)
        with res as p:
            assert p is self.params and res.resident and res.swap_count == 0
        assert isinstance(wrap_params(self.params, True, "cpu"), OffloadedParams)
        assert isinstance(wrap_params(self.params, False, "cpu"), ResidentParams)

    def test_offload_defaults_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("this machine has CUDA; the default device is valid")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            OffloadedParams(self.params)

    def test_interface_swaps_around_encode_and_decode(self, services):
        """offload=True: the tokenizer is resident only inside encode/decode
        calls, and the results equal the resident interface's."""
        _, tsvc = services
        ref = tsvc.iface
        off = TMM.SeedLlamaInterface(ref.engine, ref.tok_params, ref.tok_cfg,
                                     offload=True, device="cpu")
        img = torch.from_numpy(
            np.random.RandomState(7).randn(1, 28, 28, 3).astype(np.float32))
        codes = off.encode_image(img)
        assert off._tok.swap_count == 1 and not off._tok.resident
        np.testing.assert_array_equal(codes, ref.encode_image(img))
        emb = off.decode_image(codes)
        assert off._tok.swap_count == 2 and not off._tok.resident
        np.testing.assert_array_equal(emb, ref.decode_image(codes))
        segs = off.generate([codes[0], "hi"], TE.GenerationConfig(
            max_new_tokens=4, do_sample=False))
        assert [s.kind for s in segs] == [s.kind for s in ref.generate(
            [codes[0], "hi"], TE.GenerationConfig(max_new_tokens=4,
                                                  do_sample=False))]


def test_hf_text_tokenizer_imports_lazily():
    """The class is there; transformers is imported only when one is built."""
    assert TMM.HFTextTokenizer.__init__.__code__.co_names[0] == "transformers"
    assert callable(TMM.HFTextTokenizer.encode)
