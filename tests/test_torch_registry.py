"""The registry and logging layer of seed_tpu_torch against seed_tpu, on the
CPU: ``lookup`` / ``instantiate`` / ``load_config`` with the port's names
for every file of ``configs/`` (cut to tiny models), the int8 build that
never holds the full-precision model, the mixture datapipe record for
record, the meters, JSON-lines log, step timer and profiler trace, and the
small tree helpers.

Contracts: the port's trees have seed_tpu's structure, and on seed_tpu's
weights (carried across by the bridge) give its outputs (ids equal, logits
within 1e-5 of their scale); the int8 build bit-equal to ``quantize_tree``
of the full-precision build from the same seed; the datapipe's batches
equal; the meters' statistics equal.
"""
import io
import itertools
import json
import pickle
import tarfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seed_tpu.registry_defs  # noqa: F401  (registers seed_tpu's names)
import seed_tpu_torch.registry_defs  # noqa: F401  (registers the port's)
from seed_tpu.models import layers as JL
from seed_tpu.models import llama as JM
from seed_tpu.models import seed_tokenizer as JST
from seed_tpu.ops import quantization as JQ
from seed_tpu.utils import instantiate as j_instantiate
from seed_tpu.utils import metrics_logging as JML
from seed_tpu_torch import bridge
from seed_tpu_torch.models import layers as TL
from seed_tpu_torch.models import llama as TM
from seed_tpu_torch.models import seed_tokenizer as TST
from seed_tpu_torch.ops import quantization as TQ
from seed_tpu_torch.utils import metrics_logging as TML
from seed_tpu_torch.utils.registry import (instantiate, load_config, lookup,
                                           register)
from seed_tpu_torch.utils.tree import leaves_with_path

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def port(tree):
    return bridge.from_seed_tpu(jax.tree.map(np.asarray, tree), device="cpu")


def structure(tree):
    return {p: (tuple(x.shape), x.dtype) for p, x in leaves_with_path(tree)}


# --------------------------------------------------------------- registry

def test_lookup_names_and_dotted_paths():
    from seed_tpu_torch.registry_defs import make_seed_llama
    assert lookup("seed_llama") is make_seed_llama
    for name in ("seed_tokenizer", "unclip_decoder", "clip_transform",
                 "caption_datapipe", "multi_datapipe"):
        assert callable(lookup(name))
    assert lookup("seed_tpu_torch.models.llama.init_llama") is TM.init_llama
    with pytest.raises(KeyError, match="unknown registry name"):
        lookup("no_such_name")
    # the port's registry is its own: seed_tpu's names build seed_tpu's
    assert lookup("seed_llama") is not seed_tpu.registry_defs.make_seed_llama


def test_register_refuses_a_taken_name_and_instantiate_recurses():
    @register("torch_test_pair")
    def pair(a, b=0):
        return (a, b)

    with pytest.raises(KeyError, match="already taken"):
        register("torch_test_pair")(lambda: None)
    cfg = {"_target_": "torch_test_pair", "a": {"_target_": "torch_test_pair",
                                                "a": 1}}
    assert instantiate(cfg) == ((1, 0), 0)
    assert instantiate(cfg, b=5) == ((1, 0), 5)
    lazy = dict(cfg, _recursive_=False)
    assert instantiate(lazy)[0] == {"_target_": "torch_test_pair", "a": 1}
    assert instantiate(3) == 3


def test_load_config_json_and_yaml_subset(tmp_path):
    (tmp_path / "c.yaml").write_text('{"_target_": "seed_llama", "x": [1]}')
    assert load_config(str(tmp_path / "c.yaml"))["x"] == [1]
    for path in sorted(CONFIGS.glob("*.json")):
        assert load_config(str(path)) == json.loads(path.read_text())


def test_tokenizer_config_builds_the_port_tokenizer():
    cfg = load_config(str(CONFIGS / "tokenizer.json"))
    tiny = dict(arch="tiny", dtype="float32")
    params, tcfg = instantiate(cfg, device="cpu", seed=2, **tiny)
    jparams, jcfg = j_instantiate(cfg, **tiny)
    assert tcfg == TST.TINY_TOKENIZER
    ported = port(jparams)
    assert structure(params) == structure(ported)
    images = np.random.RandomState(0).randn(2, 28, 28, 3).astype(np.float32)
    want = JST.encode(jparams, jnp.asarray(images), jcfg)
    got = TST.encode(ported, torch.from_numpy(images), tcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    again, _ = instantiate(cfg, device="cpu", seed=2, **tiny)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        leaves_with_path(params), leaves_with_path(again)))


@pytest.mark.parametrize("name", ["seed_llama_8b.json",
                                  "seed_llama_8b_8bit.json"])
def test_llama_configs_build_the_port_model(name):
    cfg = load_config(str(CONFIGS / name))
    params, mcfg = instantiate(cfg, model="tiny", dtype="float32",
                               device="cpu")
    jparams, jcfg = j_instantiate(cfg, model="tiny", dtype="float32")
    assert mcfg == TM.TINY_LLAMA
    ported = port(jparams)
    assert structure(params) == structure(ported)
    ids = np.random.RandomState(1).randint(0, 270, (2, 12)).astype(np.int32)
    want = np.asarray(JM.forward(jparams, jnp.asarray(ids), jcfg))
    got = TM.forward(ported, torch.from_numpy(ids), mcfg).numpy()
    scale = np.abs(want[..., :270]).max()
    np.testing.assert_allclose(got[..., :270], want[..., :270], rtol=0,
                               atol=1e-5 * scale)


def test_seed_llama_int8_equals_quantize_tree_of_the_full_init():
    kw = dict(_target_="seed_llama", model="tiny", dtype="bfloat16", seed=3,
              device="cpu")
    q, _ = instantiate(dict(kw, int8=True))
    full, _ = instantiate(kw)
    want = TQ.quantize_tree(full)
    got = dict(leaves_with_path(q))
    assert set(got) == {p for p, _ in leaves_with_path(want)}
    assert "layers/0/q_proj/kernel_q" in got and "lm_head/kernel_q" in got
    for path, x in leaves_with_path(want):
        assert got[path].dtype == x.dtype and torch.equal(got[path], x), path


def test_clip_transform_and_unclip_decoder(tmp_path):
    images = np.random.RandomState(4).randint(0, 256, (2, 30, 34, 3), np.uint8)
    tf = instantiate({"_target_": "clip_transform", "image_size": 28,
                      "dtype": "float32"})
    jtf = j_instantiate({"_target_": "clip_transform", "image_size": 28,
                         "dtype": "float32"})
    np.testing.assert_allclose(tf(torch.from_numpy(images)).numpy(),
                               np.asarray(jtf(jnp.asarray(images))),
                               rtol=0, atol=1e-6)
    from seed_tpu_torch.models.unclip import (TINY_UNCLIP, UnCLIPDecoder,
                                              init_unclip)
    from seed_tpu_torch.utils.checkpoint import save_checkpoint
    tree = init_unclip(torch.Generator().manual_seed(1), TINY_UNCLIP,
                       device="cpu")
    save_checkpoint(str(tmp_path / "unclip"), tree)
    dec = instantiate({"_target_": "unclip_decoder", "num_inference_steps": 2,
                       "checkpoint": str(tmp_path / "unclip"),
                       "device": "cpu"})
    assert isinstance(dec, UnCLIPDecoder) and dec.num_inference_steps == 2
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        leaves_with_path(dec.params), leaves_with_path(tree)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            instantiate({"_target_": "seed_llama", "model": "tiny"})


def write_pkl_shard(path: Path, prefix: str, n: int):
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            data = pickle.dumps({"image_ids": list(range(i, i + 32)),
                                 "text": f"{prefix} caption number {i}"})
            info = tarfile.TarInfo(f"{prefix}{i:03d}.pkl")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


def test_pretrain_mixture_yields_seed_tpu_records_in_order(tmp_path):
    for sub in ("caption", "t2i"):
        (tmp_path / sub).mkdir()
        for s in range(2):
            write_pkl_shard(tmp_path / sub / f"{s:03d}.tar", f"{sub}{s}_", 12)
    cfg = load_config(str(CONFIGS / "pretrain_mixture.json"))
    for name, sub in (("caption", "caption"), ("caption_t2i", "t2i")):
        cfg["sources"][name].update(pattern=str(tmp_path / sub / "*.tar"),
                                    batch_size=4, max_length=48, shuffle=8)
    got = list(itertools.islice(instantiate(cfg), 14))
    want = list(itertools.islice(j_instantiate(cfg), 14))
    assert len(got) == len(want) == 14
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                          err_msg=k)


# ---------------------------------------------------------------- logging

def test_smoothed_value_statistics_equal_seed_tpu():
    values = [3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0, 6.0]
    got, want = TML.SmoothedValue(window=5), JML.SmoothedValue(window=5)
    for i, v in enumerate(values):
        got.update(v, n=1 + i % 2)
        want.update(v, n=1 + i % 2)
    for attr in ("median", "avg", "global_avg", "count", "total"):
        assert getattr(got, attr) == getattr(want, attr), attr
    got.synchronize_between_processes()    # no process group: nothing
    assert got.count == want.count


def _sync_worker(rank, world, port, out):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        m = TML.MetricLogger()
        m.update(loss=1.0 + rank)
        m.update(loss=2.0 * (rank + 1))
        m.meters["loss"].synchronize_between_processes()
        out.put((rank, m.meters["loss"].count, m.meters["loss"].total))
    finally:
        dist.destroy_process_group()


def test_meters_sum_across_a_process_group():
    import socket
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port_no = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_sync_worker, args=(r, 2, port_no, out))
             for r in range(2)]
    for p in procs:
        p.start()
    got = sorted(out.get(timeout=120) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    # rank 0 logged 1 + 2, rank 1 logged 2 + 4
    assert got == [(0, 4, 9.0), (1, 4, 9.0)]


def test_metric_logger_json_lines_and_log_every(tmp_path, capsys):
    log = tmp_path / "logs" / "log.txt"
    got = TML.MetricLogger(log_file=str(log))
    want = JML.MetricLogger(log_file=str(tmp_path / "j.txt"))
    for i in range(4):
        got.update(loss=torch.tensor(1.0 / (i + 1), dtype=torch.float64),
                   lr=1e-3 * i)
        want.update(loss=1.0 / (i + 1), lr=1e-3 * i)
    assert str(got) == str(want)
    got.write_json_line(epoch=1)
    got.write_json_line(epoch=2)
    want.write_json_line(epoch=1)
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    assert lines[0] == json.loads((tmp_path / "j.txt").read_text())
    assert [x["epoch"] for x in lines] == [1, 2]
    assert list(got.log_every(range(5), 2, header="ev", total=5)) == \
        list(range(5))
    out = capsys.readouterr().out
    assert "ev [0/5]" in out and "ev [4/5]" in out and "ev done" in out
    TML.MetricLogger().write_json_line(x=1)    # no file: nothing


def test_step_timer_and_profile_trace(tmp_path):
    timer = TML.StepTimer()
    timer.start()
    x = torch.randn(64, 64)
    y = x @ x
    assert timer.stop(sync=y) >= 0.0 and timer.stop() >= 0.0
    trace_dir = tmp_path / "trace"
    with TML.profile_trace(str(trace_dir)) as prof:
        (x @ x).sum()
    assert prof is not None
    traces = list(trace_dir.glob("trace_*.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())
    with TML.profile_trace(str(trace_dir), enabled=False) as prof:
        pass
    assert prof is None and len(list(trace_dir.glob("trace_*.json"))) == 1


def test_build_logger_writes_a_shared_file(tmp_path):
    import logging
    root = logging.getLogger()
    before = list(root.handlers)
    try:
        logger = TML.build_logger("seed_port_test", str(tmp_path))
        logger.info("hello port")
        for h in root.handlers:
            h.flush()
        assert "hello port" in (tmp_path / "seed_port_test.log").read_text()
    finally:
        for h in root.handlers[:]:
            if h not in before:
                root.removeHandler(h)
                h.close()


# ----------------------------------------------------------- tree helpers

def test_count_params_cast_tree_and_quantized_bytes_equal_seed_tpu():
    jparams = JM.init_llama(jax.random.PRNGKey(0), JM.TINY_LLAMA, jnp.float32)
    tparams = port(jparams)
    assert TL.count_params(tparams) == JL.count_params(jparams)
    jq = JQ.quantize_tree(jparams)
    tq = TQ.quantize_tree(tparams)
    assert TQ.quantized_bytes(tq) == JQ.quantized_bytes(jq)
    assert TQ.quantized_bytes(tparams) == JQ.quantized_bytes(jparams)
    cast = TL.cast_tree(tq, torch.bfloat16)
    jcast = port(JL.cast_tree(jq, jnp.bfloat16))
    assert structure(cast) == structure(jcast)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        leaves_with_path(cast), leaves_with_path(jcast)))
