"""seed_tpu_torch.parallel against seed_tpu.parallel, on the CPU: the
partition specs (no ranks needed), and ring attention, the
sequence-parallel loss, the GPipe losses and the ``axis_name`` hooks in one
group of eight gloo ranks (spawned processes).

Inputs are made from numpy seeds; seed_tpu runs on its eight virtual CPU
devices (conftest), the port in the ranks. Tolerances are those of the JAX
tests each check mirrors: ring attention and the SP loss 2e-5, their
gradients 3e-5 / (5e-5, rtol 5e-4) (tests/test_sequence_parallel.py);
pipeline losses 2e-5, pipeline gradients rtol 1e-4, atol 1e-5
(tests/test_multichip.py); the axis_name losses 1e-5 relative and their
gradients 1e-4 (tests/test_torch_discrete_vision.py); specs equal.

``run_ranks`` starts a group of gloo ranks that meet through a FileStore
under the test's temporary directory. The group has a deadline of its own
(240 s by default, about 4x what the slowest group here takes on an idle
machine, so that a loaded test host does not trip it): ranks still running
then are killed and the test fails,
so a collective that one rank never reaches cannot stall the suite.
"""
import datetime
import multiprocessing
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

from seed_tpu_torch import bridge
from seed_tpu_torch import parallel as TP
from seed_tpu_torch.models import llama as TM
from seed_tpu_torch.parallel import comm

RING = dict(atol=2e-5, rtol=2e-5)
RING_GRAD = dict(atol=3e-5, rtol=3e-5)
SP_GRAD = dict(atol=5e-5, rtol=5e-4)
PIPE_LOSS = dict(atol=2e-5, rtol=2e-5)
PIPE_GRAD = dict(rtol=1e-4, atol=1e-5)
LOSS = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)

GROUP_TIMEOUT_S = 240


# ------------------------------------------------------------ rank groups

def _rank_main(fn, rank, world, store, out):
    import torch.distributed as dist
    torch.set_num_threads(1)
    args = torch.load(f"{out}/args.pt", weights_only=False)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        torch.save(fn(rank, world, *args), f"{out}/out{rank}.pt")
    except BaseException:
        Path(f"{out}/err{rank}.txt").write_text(traceback.format_exc())
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world, directory, *args, timeout=GROUP_TIMEOUT_S):
    """``fn(rank, world, *args)`` on ``world`` gloo ranks in spawned
    processes; returns their results in rank order. Fails (after killing
    every rank) if the group has not finished within ``timeout`` seconds or
    if a rank raised."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    # the inputs go through a file: through each process's start-up pipe,
    # the parent would wait for every child to boot in turn
    torch.save(args, directory / "args.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, str(directory / "store"),
                               str(directory)), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    errors = [(directory / f"err{r}.txt").read_text() for r in range(world)
              if (directory / f"err{r}.txt").exists()]
    if errors:
        pytest.fail("ranks raised:\n" + "\n".join(errors))
    if hung:
        pytest.fail(f"ranks {hung} did not finish within {timeout} s")
    return [torch.load(directory / f"out{r}.pt", weights_only=False)
            for r in range(world)]


# ------------------------------------------------------------ inputs

def qkv(seed, B, S, H, Hkv, D):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, S, H, D).astype(np.float32),
            rs.randn(B, S, Hkv, D).astype(np.float32),
            rs.randn(B, S, Hkv, D).astype(np.float32))


RING_CASES = {                 # name: (mesh (dp, fsdp), qkv args, causal)
    "causal_sp2": ((2, 4), (0, 2, 32, 4, 4, 16), True),
    "causal_sp4": ((4, 2), (0, 2, 32, 4, 4, 16), True),
    "causal_sp8": ((8, 1), (0, 2, 32, 4, 4, 16), True),
    "noncausal": ((4, 2), (1, 2, 24, 4, 4, 16), False),
    "gqa": ((4, 2), (2, 2, 16, 8, 2, 8), True),
}
PIPE_CFG = dict(vocab_size=270, dim=32, heads=2, kv_heads=2, ffn_dim=64,
                max_seq_len=32)
PIPE_CASES = {     # name: (fsdp variant, layers, ids (seed, B, N), M, mesh)
    "pipe4_loss": (False, 4, (0, 8, 16), 4, dict(dp=2, fsdp=1, pp=4)),
    "pipe2_grads": (False, 2, (1, 4, 8), 2, dict(dp=2, fsdp=2, pp=2)),
    "fsdp_loss": (True, 4, (3, 8, 8), 2, dict(dp=2, fsdp=2, pp=2)),
    "fsdp_grads": (True, 2, (4, 8, 8), 2, dict(dp=1, fsdp=4, pp=2)),
}


def ids_of(seed, B, N, vocab=270):
    return np.random.RandomState(seed).randint(3, vocab, size=(B, N)).astype(np.int32)


def feats(seed, n=16, d=8, normalize=True):
    rs = np.random.RandomState(seed)
    a, b = rs.randn(n, d).astype(np.float32), rs.randn(n, d).astype(np.float32)
    if normalize:
        a /= np.linalg.norm(a, axis=-1, keepdims=True)
        b /= np.linalg.norm(b, axis=-1, keepdims=True)
    return a, b


def jax_llama(cfg_kw, seed):
    import jax
    import jax.numpy as jnp
    from seed_tpu.models import llama as JM
    cfg = JM.LlamaConfig(**cfg_kw)
    params = JM.init_llama(jax.random.PRNGKey(seed), cfg, dtype=jnp.float32)
    return cfg, params, jax.tree.map(np.asarray, params)


# ------------------------------------------------------------ the ranks

def _np(t):
    return t.detach().numpy().copy()


def _grads(tree):
    from seed_tpu_torch.utils.tree import leaves_with_path
    return {p: (None if x.grad is None else _np(x.grad))
            for p, x in leaves_with_path(tree)}


def parallel_checks(rank, world, llama_np, pipe_np, ema_np):
    """Every check of this file that needs ranks; returns numpy results."""
    from seed_tpu_torch.models import discrete_vision as TDV
    from seed_tpu_torch.models import quantizer as TQ
    from seed_tpu_torch.train import losses as TLOSS
    from seed_tpu_torch.utils.tree import tree_map
    out = {}
    for name, ((dp, fsdp), args, causal) in RING_CASES.items():
        mesh = TP.make_mesh(dp=dp, fsdp=fsdp, device_type="cpu")
        q, k, v = (torch.from_numpy(a) for a in qkv(*args))
        out[name] = _np(TP.sequence_parallel_attention(
            q, k, v, mesh, axis="data", causal=causal))
    # gradients through the ring
    mesh = TP.make_mesh(dp=4, fsdp=2, device_type="cpu")
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in qkv(3, 1, 16, 2, 2, 8))
    TP.sequence_parallel_attention(q, k, v, mesh, axis="data").sum().backward()
    out["ring_grads"] = [_np(t.grad) for t in (q, k, v)]

    # the sequence-parallel LLaMA loss
    cfg = TM.TINY_LLAMA
    params = bridge.from_seed_tpu(llama_np, "cpu")
    ids = torch.from_numpy(ids_of(0, 2, 32))
    out["sp_loss"] = float(TP.llama_loss_sp(params, ids, cfg, mesh, "data"))
    labels = ids_of(1, 2, 16)
    labels[:, :7] = -100
    mesh24 = TP.make_mesh(dp=2, fsdp=4, device_type="cpu")
    out["sp_loss_masked"] = float(TP.llama_loss_sp(
        params, torch.from_numpy(ids_of(1, 2, 16)), cfg, mesh24, "data",
        labels=torch.from_numpy(labels)))
    live = tree_map(lambda x: x.clone().requires_grad_(), params)
    TP.llama_loss_sp(live, torch.from_numpy(ids_of(2, 1, 16)), cfg, mesh,
                     "data").backward()
    out["sp_grads"] = _grads(live)

    # GPipe
    for name, (fsdp_variant, layers, idargs, M, shape) in PIPE_CASES.items():
        pcfg = TM.LlamaConfig(layers=layers, **PIPE_CFG)
        live = tree_map(lambda x: x.clone().requires_grad_(),
                        bridge.from_seed_tpu(pipe_np[layers], "cpu"))
        mesh = TP.make_mesh(device_type="cpu", **shape)
        fn = (TP.pipeline_fsdp_llama_loss if fsdp_variant
              else TP.pipeline_llama_loss)
        loss = fn(live, torch.from_numpy(ids_of(*idargs)), pcfg, mesh, M)
        loss.backward()
        out[name] = {"loss": float(loss.detach()), "grads": _grads(live),
                     "stage": comm.index_of("pipe")}

    # the axis_name hooks, over all eight ranks
    mesh = TP.make_mesh(dp=8, fsdp=1, device_type="cpu")
    a, b = (torch.from_numpy(x).chunk(world)[rank].clone().requires_grad_()
            for x in feats(5))
    loss = TLOSS.info_nce(a, b, 0.07, axis_name="data")
    (loss / world).backward()
    out["info_nce"] = (float(loss.detach()), _np(a.grad), _np(b.grad))
    x, y = (torch.from_numpy(t).chunk(world)[rank].clone().requires_grad_()
            for t in feats(6, normalize=False))
    loss = TDV.clip_contrastive_loss(torch.tensor(2.6592), x, y,
                                     axis_name="data")
    (loss / world).backward()
    out["clip_contrastive"] = (float(loss.detach()), _np(x.grad), _np(y.grad))
    ema, z, idx = ema_np
    z_l = torch.from_numpy(z).chunk(world)[rank]
    i_l = torch.from_numpy(idx).chunk(world)[rank]
    new = TQ.norm_ema_update(bridge.from_seed_tpu(ema, "cpu"), z_l, i_l,
                             decay=0.9, axis_name="data")
    out["norm_ema"] = {k: _np(v) for k, v in new.items()}
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from seed_tpu.models import quantizer as JQ
    _, _, llama_np = jax_llama(vars(TM.TINY_LLAMA), 0)
    pipe_np = {n: jax_llama(dict(PIPE_CFG, layers=n), 0)[2] for n in (2, 4)}
    ema = JQ.init_ema_codebook(jax.random.PRNGKey(7), 16, 8)
    z = np.random.RandomState(8).randn(24, 8).astype(np.float32)
    idx = np.asarray(JQ.norm_ema_quantize(ema, jnp.asarray(z)).indices)
    ema_np = (jax.tree.map(np.asarray, ema), z, idx)
    return run_ranks(parallel_checks, 8, tmp_path_factory.mktemp("ranks"),
                     llama_np, pipe_np, ema_np)


# ------------------------------------------------------------ tests

@pytest.mark.parametrize("name", sorted(RING_CASES))
def test_ring_attention_matches_seed_tpu(ranks, name):
    import jax
    import jax.numpy as jnp
    from seed_tpu.parallel import make_mesh, sequence_parallel_attention
    (dp, fsdp), args, causal = RING_CASES[name]
    q, k, v = (jnp.asarray(a) for a in qkv(*args))
    mesh = make_mesh(dp=dp, fsdp=fsdp)
    want = jax.jit(lambda q, k, v: sequence_parallel_attention(
        q, k, v, mesh, axis="data", causal=causal))(q, k, v)
    for r in ranks:            # every rank returns the global output
        np.testing.assert_allclose(r[name], np.asarray(want), **RING)


def test_ring_attention_grads_match_seed_tpu(ranks):
    import jax
    import jax.numpy as jnp
    from seed_tpu.parallel import make_mesh, sequence_parallel_attention
    mesh = make_mesh(dp=4, fsdp=2)
    q, k, v = (jnp.asarray(a) for a in qkv(3, 1, 16, 2, 2, 8))
    want = jax.jit(jax.grad(lambda q, k, v: sequence_parallel_attention(
        q, k, v, mesh, axis="data").sum(), argnums=(0, 1, 2)))(q, k, v)
    for r in ranks:
        for got, w in zip(r["ring_grads"], want):
            np.testing.assert_allclose(got, np.asarray(w), **RING_GRAD)


@pytest.mark.parametrize("case", ["plain", "masked_labels"])
def test_llama_loss_sp_matches_seed_tpu(ranks, case):
    import jax
    import jax.numpy as jnp
    from seed_tpu.parallel import llama_loss_sp, make_mesh
    cfg, params, _ = jax_llama(vars(TM.TINY_LLAMA), 0)
    if case == "plain":
        mesh = make_mesh(dp=4, fsdp=2)
        want = jax.jit(lambda p, i: llama_loss_sp(p, i, cfg, mesh, axis="data"))(
            params, jnp.asarray(ids_of(0, 2, 32)))
        key = "sp_loss"
    else:
        labels = ids_of(1, 2, 16)
        labels[:, :7] = -100
        mesh = make_mesh(dp=2, fsdp=4)
        want = jax.jit(lambda p, i, l: llama_loss_sp(
            p, i, cfg, mesh, axis="data", labels=l))(
                params, jnp.asarray(ids_of(1, 2, 16)), jnp.asarray(labels))
        key = "sp_loss_masked"
    for r in ranks:
        assert abs(r[key] - float(want)) < 2e-5, (r[key], float(want))


def _jax_grads_by_path(grads):
    """seed_tpu's gradient tree as the port's {path: array}, stacked layers
    unstacked."""
    return {p: np.asarray(x) for p, x in bridge_leaves(grads)}


def bridge_leaves(tree):
    import jax
    from seed_tpu_torch.utils.tree import leaves_with_path
    return leaves_with_path(bridge.from_seed_tpu(
        jax.tree.map(np.asarray, tree), "cpu"))


def test_llama_loss_sp_grads_match_seed_tpu(ranks):
    import jax
    import jax.numpy as jnp
    from seed_tpu.parallel import llama_loss_sp, make_mesh
    cfg, params, _ = jax_llama(vars(TM.TINY_LLAMA), 0)
    ids = jnp.asarray(ids_of(2, 1, 16))
    mesh = make_mesh(dp=4, fsdp=2)
    want = jax.jit(jax.grad(lambda p: llama_loss_sp(p, ids, cfg, mesh,
                                                    axis="data")))(params)
    for path, w in bridge_leaves(want):
        for r in ranks:
            np.testing.assert_allclose(r["sp_grads"][path], w.numpy(),
                                       err_msg=path, **SP_GRAD)


@pytest.mark.parametrize("name", sorted(PIPE_CASES))
def test_pipeline_matches_unsharded_seed_tpu(ranks, name):
    """Loss and (for the grads cases) every gradient against seed_tpu's
    unsharded forward, as tests/test_multichip.py holds seed_tpu's own
    pipeline: a layer's gradient is the sum of what the ranks that hold it
    return for it, divided by how many hold each element."""
    import jax
    import jax.numpy as jnp
    from seed_tpu.models import llama as JM
    from seed_tpu.train.losses import next_token_loss
    fsdp_variant, layers, idargs, M, shape = PIPE_CASES[name]
    cfg, params, _ = jax_llama(dict(PIPE_CFG, layers=layers), 0)
    ids = jnp.asarray(ids_of(*idargs))
    loss = lambda p: next_token_loss(JM.forward(p, ids, cfg), ids)
    for r in ranks:
        np.testing.assert_allclose(r[name]["loss"],
                                   float(jax.jit(loss)(params)), **PIPE_LOSS)
    if not name.endswith("grads"):
        return
    want = dict(bridge_leaves(jax.jit(jax.grad(loss))(params)))
    for path, w in want.items():
        w = w.numpy()
        if path.startswith("layers/"):
            held = [r[name]["grads"][path] for r in ranks
                    if r[name]["grads"][path] is not None
                    and np.any(r[name]["grads"][path])]
            got = np.sum(held, axis=0)
            # elements held by several ranks (replicas over data / tensor)
            count = np.sum([g != 0 for g in held], axis=0)
            got = got / np.maximum(count, 1)
        else:
            got = ranks[0][name]["grads"][path]
        np.testing.assert_allclose(got, w, err_msg=path, **PIPE_GRAD)


@pytest.mark.parametrize("hook", ["info_nce", "clip_contrastive"])
def test_axis_name_losses_match_seed_tpu(ranks, hook):
    """Each rank's loss over the gathered global batch, and the gradient of
    the mean over ranks for each rank's block, against seed_tpu under
    shard_map with the same axis name."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP
    from seed_tpu.models import discrete_vision as JDV
    from seed_tpu.parallel import make_mesh
    from seed_tpu.parallel.pipeline import shard_map
    from seed_tpu.train import losses as JLOSS
    mesh = make_mesh(dp=8, fsdp=1)
    if hook == "info_nce":
        a, b = feats(5)
        fn = lambda x, y: JLOSS.info_nce(x, y, 0.07, axis_name="data")
    else:
        a, b = feats(6, normalize=False)
        fn = lambda x, y: JDV.clip_contrastive_loss(
            jnp.asarray(2.6592), x, y, axis_name="data")
    per_rank = shard_map(lambda x, y: fn(x, y)[None], mesh,
                         in_specs=(JP("data"), JP("data")),
                         out_specs=JP("data"))
    a, b = jnp.asarray(a), jnp.asarray(b)
    losses = jax.jit(per_rank)(a, b)
    ga, gb = jax.jit(jax.grad(lambda x, y: per_rank(x, y).mean(),
                              argnums=(0, 1)))(a, b)
    for i, r in enumerate(ranks):
        loss, got_a, got_b = r[hook]
        np.testing.assert_allclose(loss, float(losses[i]), **LOSS)
        np.testing.assert_allclose(got_a, np.asarray(ga).reshape(8, -1, 8)[i],
                                   **GRAD)
        np.testing.assert_allclose(got_b, np.asarray(gb).reshape(8, -1, 8)[i],
                                   **GRAD)


def test_norm_ema_update_axis_name_matches_seed_tpu(ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP
    from seed_tpu.models import quantizer as JQ
    from seed_tpu.parallel import make_mesh
    from seed_tpu.parallel.pipeline import shard_map
    ema = JQ.init_ema_codebook(jax.random.PRNGKey(7), 16, 8)
    z = jnp.asarray(np.random.RandomState(8).randn(24, 8).astype(np.float32))
    idx = JQ.norm_ema_quantize(ema, z).indices
    step = shard_map(
        lambda zz, ii: JQ.norm_ema_update(ema, zz, ii, decay=0.9,
                                          axis_name="data"),
        make_mesh(dp=8, fsdp=1), in_specs=(JP("data"), JP("data")),
        out_specs=JP())
    want = step(z, idx)
    for r in ranks:
        for k in ("codebook", "cluster_size", "embed_avg"):
            np.testing.assert_allclose(r["norm_ema"][k], np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


# ------------------------------------------------------------ specs

SPEC_MESHES = [(1, 8, 1, 1), (1, 4, 1, 2), (2, 2, 1, 2)]   # (dp, fsdp, pp, tp)


def _norm(spec):
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _port_path_to_seed_tpu(path):
    parts = path.split("/")
    return "/".join(p for i, p in enumerate(parts)
                    if not (p.isdigit() and i and parts[i - 1] in bridge.STACKED_KEYS))


@pytest.mark.parametrize("mesh_shape", SPEC_MESHES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("model", ["llama_8b", "seed_tokenizer"])
def test_param_specs_equal_seed_tpu(model, mesh_shape):
    """The specs of the full 8B and SEED-tokenizer trees (meta tensors
    against jax.eval_shape) equal seed_tpu's leaf for leaf; seed_tpu's
    stacked layers carry one more, leading, unsharded dim."""
    import jax
    import jax.numpy as jnp
    from seed_tpu.models import llama as JM
    from seed_tpu.models import seed_tokenizer as JS
    from seed_tpu.parallel import make_mesh as j_make_mesh
    from seed_tpu.parallel import make_param_specs as j_specs
    from seed_tpu.parallel.partition import path_str as j_path_str
    from seed_tpu_torch.models import seed_tokenizer as TS
    from seed_tpu_torch.utils.tree import leaves_with_path
    dp, fsdp, pp, tp = mesh_shape
    key = jax.random.PRNGKey(0)
    if model == "llama_8b":
        jtree = jax.eval_shape(lambda: JM.init_llama(key, JM.SEED_LLAMA_8B))
        ttree = TM.init_llama(torch.Generator(), TM.SEED_LLAMA_8B,
                              device="meta")
        rules, jrules = TP.LLAMA_TP_RULES, __import__(
            "seed_tpu.parallel", fromlist=["x"]).LLAMA_TP_RULES
    else:
        jtree = jax.eval_shape(lambda: JS.init_seed_tokenizer(
            key, JS.SEED_TOKENIZER))
        ttree = TS.init_seed_tokenizer(torch.Generator(), TS.SEED_TOKENIZER,
                                       torch.float32, device="meta")
        rules, jrules = TP.VIT_TP_RULES, __import__(
            "seed_tpu.parallel", fromlist=["x"]).VIT_TP_RULES
    jmesh = j_make_mesh(dp=dp, fsdp=fsdp, tp=tp, pp=pp)
    want = {j_path_str(p): (tuple(s), len(leaf.shape)) for (p, s), leaf in zip(
        jax.tree_util.tree_flatten_with_path(
            j_specs(jtree, jmesh, jrules),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0],
        jax.tree.leaves(jtree))}
    got = leaves_with_path(TP.make_param_specs(
        ttree, dict(zip(TP.AXIS_NAMES, mesh_shape)), rules))
    assert len(got) == len(leaves_with_path(ttree))
    seen = set()
    for path, spec in got:
        # seed_tpu stacks the ViT's blocks and the LLaMA's layers; its
        # Q-Former keeps a list of layers, as the port does
        jpath = path if path in want else _port_path_to_seed_tpu(path)
        jspec, jrank = want[jpath]
        seen.add(jpath)
        if jrank == len(_leaf(ttree, path).shape) + 1:      # stacked
            assert jspec[:1] in ((), (None,)), (path, jspec)
            jspec = jspec[1:]
        assert _norm(spec) == _norm(jspec), (path, spec, jspec)
    assert seen == set(want)


def _leaf(tree, path):
    for p in path.split("/"):
        tree = tree[int(p)] if isinstance(tree, list) else tree[p]
    return tree


def test_parallel_exports_every_name_of_seed_tpu_parallel():
    import seed_tpu.parallel as JP
    assert list(TP.__all__) == list(JP.__all__)
    assert all(callable(getattr(TP, n)) or isinstance(getattr(TP, n), (str, tuple, list))
               for n in TP.__all__)
