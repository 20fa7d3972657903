"""The port's sharded programs against seed_tpu's, on the CPU in gloo ranks
(spawned processes, ``test_torch_parallel.run_ranks``, each group with its
own 240 s deadline): the mesh Trainer at (fsdp=4, tp=2) against seed_tpu's
sharded Trainer, on a batch whose valid-token counts differ by rank; the
flash wrapper on the local heads; checkpoints that move between mesh
shapes; ``train_llm --tp 2`` against ``--tp 1`` and against seed_tpu's
Trainer on ``auto_mesh(2, tp=2)``; both ``train_tokenizer`` stages under
FSDP, and each stage's loss through the mesh Trainer against seed_tpu's on
one global batch; the sharded engine (its KV cache holding each rank's own
heads) and encode against the unsharded ones.

Tolerances: the mesh Trainer's loss rtol 1e-4 (tests/test_train.py:223),
its grad_norm rtol 1e-4, its parameters after three steps atol 1e-4 (a
tenth of one step at lr 1e-3: Adam divides by sqrt(v), so the fp32
sum-order differences of an embedding row that is seen once move its
update); engine tokens and encode ids exact.
"""
import numpy as np
import pytest
import torch

from seed_tpu_torch import bridge
from seed_tpu_torch import parallel as TP
from seed_tpu_torch.models import llama as TM
from seed_tpu_torch.utils.tree import leaves_with_path
from test_torch_parallel import run_ranks

MESH = dict(dp=1, fsdp=4, tp=2)
SCHED = dict(base_lr=1e-3, warmup_steps=1, total_steps=4, min_lr_ratio=0.05)
OPT = dict(b2=0.95, eps=1e-5, weight_decay=0.05, clip_norm=1.0)
STEPS = 3


def padded_batches(n=STEPS, B=8, N=16):
    """Rows 0-1 (rank slice 0 under fsdp=4) are mostly padding, the others
    are not: the valid-token counts differ by rank."""
    out = []
    for i in range(n):
        rs = np.random.RandomState(10 + i)
        ids = rs.randint(3, 260, (B, N)).astype(np.int64)
        mask = np.ones_like(ids)
        mask[0, 4:] = 0
        mask[1, 9:] = 0
        labels = np.where(mask == 1, ids, -100)
        out.append({"input_ids": ids, "attention_mask": mask, "labels": labels})
    return out


def _np(t):
    return t.detach().float().numpy().copy()


def torch_loss(cfg):
    from seed_tpu_torch.train.losses import cross_entropy

    def loss_fn(p, batch, rng):
        logits = TM.forward(p, batch["input_ids"], cfg,
                            attn_mask=batch["attention_mask"], use_flash=True)
        return cross_entropy(logits[:, :-1], batch["labels"][:, 1:])
    return loss_fn


def trainer_checks(rank, world, params_np, directory, tok_np, images):
    """The mesh Trainer: three steps at (fsdp=4, tp=2), the heads the flash
    wrapper saw, the bytes a rank holds, a save at this mesh restored at
    (fsdp=8, tp=1) and into a Trainer without a mesh; then the engine and
    the encode on trees sharded at (fsdp=4, tp=2)."""
    from seed_tpu_torch.ops import flash_attention as FA
    from seed_tpu_torch.parallel.partition import full_tree
    from seed_tpu_torch.train import optim as TOPT
    from seed_tpu_torch.train.trainer import Trainer, TrainerConfig
    from seed_tpu_torch.utils.checkpoint import CheckpointManager
    cfg = TM.TINY_LLAMA
    params = bridge.from_seed_tpu(params_np, "cpu")
    out = {}
    heads = []      # (q heads, kv heads) of every local call
    flash = FA.flash_attention
    FA.flash_attention = lambda q, k, v, **kw: (
        isinstance(q, torch.Tensor) and not hasattr(q, "device_mesh")
        and heads.append((q.shape[2], k.shape[2]))) or flash(q, k, v, **kw)

    def make(mesh):
        opt = TOPT.adamw(TOPT.cosine_with_floor(**SCHED), params=params, **OPT)
        return Trainer(torch_loss(cfg), params, opt, TrainerConfig(),
                       device="cpu", mesh=mesh, rules=TP.LLAMA_TP_RULES)

    mesh = TP.make_mesh(device_type="cpu", **MESH)
    tr = make(mesh)
    local = sum(x.to_local().numel() for _, x in leaves_with_path(tr.state.params))
    out["bytes_ratio"] = local / sum(x.numel() for _, x in leaves_with_path(params))
    metrics = []
    for batch in padded_batches():
        m = tr.step(TP.shard_batch(mesh, batch))
        metrics.append({k: float(v) for k, v in m.items()})
    FA.flash_attention = flash
    out["metrics"] = metrics
    out["heads"] = sorted(set(heads))
    out["params"] = {p: _np(x) for p, x in leaves_with_path(full_tree(tr.state.params))}
    out["mu_spec_equal"] = all(
        tr.state.opt_state["mu"] is not None and
        a.placements == b.placements for (_, a), (_, b) in zip(
            leaves_with_path(tr.state.params),
            leaves_with_path(tr.state.opt_state["mu"])))

    # a save at (fsdp=4, tp=2) resumes at (fsdp=8, tp=1)
    mgr = CheckpointManager(f"{directory}/state")
    tr.save_state(mgr)
    extra = padded_batches(STEPS + 1)[-1]
    want = float(tr.step(TP.shard_batch(mesh, extra))["loss"])
    mesh2 = TP.make_mesh(dp=1, fsdp=8, tp=1, device_type="cpu")
    tr2 = make(mesh2)
    out["restored_step"] = tr2.restore_state(mgr)
    out["resumed_loss"] = (want, float(tr2.step(TP.shard_batch(mesh2, extra))["loss"]))
    if rank == 0:           # and into a trainer without a mesh
        tr3 = Trainer(torch_loss(cfg), params, TOPT.adamw(
            TOPT.cosine_with_floor(**SCHED), params=params, **OPT),
            TrainerConfig(), device="cpu")
        tr3.restore_state(mgr)
        out["no_mesh_loss"] = float(tr3.step(extra)["loss"])
    out.update(sharded_serving(params, tok_np, images))
    return out


def sharded_serving(params, tok_np, images):
    """LlamaEngine on ``shard_params(params, mesh, LLAMA_TP_RULES)`` and
    encode on a VIT_TP_RULES tree with the batch sharded, both at (fsdp=4,
    tp=2), and both unsharded in the same rank."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from seed_tpu_torch.models import seed_tokenizer as TS
    from seed_tpu_torch.parallel.mesh import BATCH_AXES, compute_mesh
    from seed_tpu_torch.parallel.partition import P, placements
    from seed_tpu_torch.serving.engine import GenerationConfig, LlamaEngine
    mesh = TP.make_mesh(device_type="cpu", **MESH)
    gen = GenerationConfig(max_new_tokens=5, do_sample=False, eos_token_id=-1)
    engine = lambda p: LlamaEngine(p, TM.TINY_LLAMA, max_len=64,
                                   cache_dtype=torch.float32, device="cpu")
    out = {"tokens": engine(params).generate([[1, 5, 9]], gen)[0]}
    sharded = TP.shard_params(params, mesh, TP.LLAMA_TP_RULES)
    with implicit_replication():
        eng = engine(sharded)
        out["tokens_sharded"] = eng.generate([[1, 5, 9]], gen)[0]
        with torch.inference_mode():
            cache = eng._prefill_prompts([[1, 5, 9]])[1]
    out["cache_heads"] = cache.k.shape[2]
    tok = bridge.from_seed_tpu(tok_np, "cpu")
    imgs = torch.from_numpy(images)
    out["ids"] = TS.encode(tok, imgs, TS.TINY_TOKENIZER).numpy()
    x = DTensor.from_local(TP.shard_batch(mesh, imgs), compute_mesh(mesh),
                           placements(mesh, P(BATCH_AXES)), run_check=False)
    with implicit_replication():
        ids = TS.encode(TP.shard_params(tok, mesh, TP.VIT_TP_RULES), x,
                        TS.TINY_TOKENIZER)
    out["ids_sharded"] = ids.full_tensor().numpy()
    return out


def jax_trainer_run(params, batches):
    """seed_tpu's Trainer on its eight devices at (fsdp=4, tp=2)."""
    import jax
    from seed_tpu.models import llama as JM
    from seed_tpu.parallel import LLAMA_TP_RULES, make_mesh
    from seed_tpu.train import optim as JOPT
    from seed_tpu.train.losses import cross_entropy
    from seed_tpu.train.trainer import Trainer

    def loss_fn(p, batch, rng):
        logits = JM.forward(p, batch["input_ids"], JM.TINY_LLAMA,
                            attn_mask=batch["attention_mask"], use_flash=True)
        return cross_entropy(logits[:, :-1], batch["labels"][:, 1:])

    opt = JOPT.adamw(JOPT.cosine_with_floor(**SCHED), params=params, **OPT)
    tr = Trainer(loss_fn, params, opt, make_mesh(**MESH),
                 rules=LLAMA_TP_RULES)
    metrics = []
    for i, b in enumerate(batches):
        m = tr.step({k: v.astype(np.int32) for k, v in b.items()},
                    jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, tr.state.params


def serving_inputs():
    """seed_tpu's TINY_TOKENIZER weights and 8 images (numpy seed 1), as
    tests/test_multichip.py shards them."""
    import jax
    from seed_tpu.models import TINY_TOKENIZER, init_seed_tokenizer
    tok = init_seed_tokenizer(jax.random.PRNGKey(0), TINY_TOKENIZER)
    images = np.random.RandomState(1).randn(8, 28, 28, 3).astype(np.float32)
    return tok, images


@pytest.fixture(scope="module")
def trainer_ranks(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from seed_tpu.models import llama as JM
    params = JM.init_llama(jax.random.PRNGKey(0), JM.TINY_LLAMA, jnp.float32)
    tok, images = serving_inputs()
    directory = tmp_path_factory.mktemp("trainer")
    got = run_ranks(trainer_checks, 8, directory,
                    jax.tree.map(np.asarray, params), str(directory),
                    jax.tree.map(np.asarray, tok), images)
    want_metrics, want_params = jax_trainer_run(params, padded_batches())
    return got, want_metrics, want_params


def test_mesh_trainer_matches_seed_tpu_sharded_trainer(trainer_ranks):
    """Three steps at (fsdp=4, tp=2) on a batch whose valid-token counts
    differ by rank: the loss of the global batch (not a mean of the ranks'
    means), the grad_norm and the parameters, against seed_tpu's Trainer
    on the same mesh shape."""
    import jax
    got, want, want_params = trainer_ranks
    # the global-batch mean differs from a mean of per-rank means here
    for i, (g, w) in enumerate(zip(got[0]["metrics"], want)):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4,
                                   err_msg=f"step {i}")
    for r in got[1:]:
        assert r["metrics"] == got[0]["metrics"]
    want_p = dict(leaves_with_path(bridge.from_seed_tpu(
        jax.tree.map(np.asarray, want_params), "cpu")))
    for path, x in got[0]["params"].items():
        np.testing.assert_allclose(x, want_p[path].numpy(), atol=1e-4,
                                   err_msg=path)


def test_mesh_trainer_runs_the_local_heads_and_holds_its_shards(trainer_ranks):
    """Under tensor=2 the attention gets H/2 query and H_kv/2 kv heads on
    every rank (never the whole heads); a rank keeps about 1/8 of the
    parameters at (fsdp=4, tp=2) and its moments have their layout."""
    got, _, _ = trainer_ranks
    cfg = TM.TINY_LLAMA
    for r in got:
        assert r["heads"] == [(cfg.heads // 2, cfg.kv_heads // 2)]
        assert r["bytes_ratio"] < 0.2, r["bytes_ratio"]
        assert r["mu_spec_equal"]


def test_mesh_checkpoint_resumes_at_another_mesh_shape(trainer_ranks):
    """A full state saved at (fsdp=4, tp=2) restores at (fsdp=8, tp=1) and
    into a Trainer without a mesh; the next step's loss equals the
    uninterrupted one's."""
    got, _, _ = trainer_ranks
    for r in got:
        assert r["restored_step"] == STEPS
        want, resumed = r["resumed_loss"]
        np.testing.assert_allclose(resumed, want, rtol=1e-5)
    np.testing.assert_allclose(got[0]["no_mesh_loss"], got[0]["resumed_loss"][0],
                               rtol=1e-5)


def test_sharded_engine_and_encode_equal_unsharded(trainer_ranks):
    """LlamaEngine on a tree from shard_params(..., LLAMA_TP_RULES) and
    encode on one from VIT_TP_RULES with the batch sharded, at (fsdp=4,
    tp=2): greedy tokens and ids equal the unsharded port's and seed_tpu's
    (tests/test_multichip.py's cases), exactly; the engine's KV cache on a
    rank holds H_kv/2 heads."""
    import jax
    import jax.numpy as jnp
    from seed_tpu.models import TINY_TOKENIZER, encode
    from seed_tpu.models import llama as JM
    from seed_tpu.serving import GenerationConfig, LlamaEngine
    got, _, _ = trainer_ranks
    params = JM.init_llama(jax.random.PRNGKey(0), JM.TINY_LLAMA, jnp.float32)
    gen = GenerationConfig(max_new_tokens=5, do_sample=False, eos_token_id=-1)
    want = LlamaEngine(params, JM.TINY_LLAMA, max_len=64,
                       cache_dtype=jnp.float32).generate([[1, 5, 9]], gen)[0]
    tok, images = serving_inputs()
    ids = np.asarray(encode(tok, jnp.asarray(images), TINY_TOKENIZER))
    for r in got:
        assert r["tokens"] == r["tokens_sharded"] == list(want)
        # each rank caches its own kv heads only
        assert r["cache_heads"] == TM.TINY_LLAMA.kv_heads // MESH["tp"]
        np.testing.assert_array_equal(r["ids"], ids)
        np.testing.assert_array_equal(r["ids_sharded"], ids)


# ------------------------------------------------------------ train_llm --tp

def llm_argv(directory, out, *extra):
    return ["--data", f"{directory}/data_*.tar", "--mode", "sft",
            "--llm-ckpt", f"{directory}/base",
            "--model", "tiny", "--steps", "3", "--batch-size", "4",
            "--grad-accum", "2", "--max-length", "48", "--save-steps", "3",
            "--log-steps", "1", "--warmup", "1", "--lr", "1e-2",
            "--output", f"{directory}/{out}", "--device", "cpu", *extra]


def train_llm_ranks(rank, world, directory):
    from seed_tpu_torch.train import train_llm
    rec = train_llm.main(llm_argv(directory, "tp2", "--tp", "2"))
    return {"losses": [r["loss"] for r in rec["log"] if "loss" in r],
            "step": rec["step"]}


def lora_to_seed_tpu(lora):
    """The port's adapters (``layers/{i}/...``, one per layer) stacked into
    seed_tpu's (``layers/...`` with a leading [L] axis), as numpy."""
    import re
    stacked = {}
    for name, ad in lora["adapters"].items():
        m = re.match(r"layers/(\d+)/(.*)", name)
        key = f"layers/{m.group(2)}"
        stacked.setdefault(key, {})[int(m.group(1))] = ad
    adapters = {k: {ab: np.stack([_np(v[i][ab]) for i in sorted(v)])
                    for ab in ("a", "b")} for k, v in stacked.items()}
    return {"adapters": adapters, "scale": _np(lora["scale"])}


def jax_tp2_losses(directory, jbase):
    """seed_tpu's Trainer on ``auto_mesh(2, tp=2)`` (the layout of ``--tp 2``
    in two ranks) with LLAMA_TP_RULES, trained as the port trains
    ``--lora``: the adapters over the closed-over fp32 base, the loss of
    scripts/train_llm.py:100-105, the script's AdamW and schedule, the
    port's initial adapters and the port's batches of the same records."""
    import jax
    import jax.numpy as jnp
    from seed_tpu.models import llama as JM
    from seed_tpu.parallel import LLAMA_TP_RULES, auto_mesh
    from seed_tpu.train import optim as JOPT
    from seed_tpu.train.lora import apply_lora
    from seed_tpu.train.losses import cross_entropy
    from seed_tpu.train.trainer import Trainer, TrainerConfig
    from seed_tpu_torch.serving.multimodal import ByteTextTokenizer
    from seed_tpu_torch.train import train_llm
    from seed_tpu_torch.train.entry import generator
    from seed_tpu_torch.train.lora import init_lora
    from seed_tpu_torch.utils.checkpoint import restore_checkpoint
    args = train_llm.parse_args(llm_argv(directory, "unused"))
    base = restore_checkpoint(args.llm_ckpt, device="cpu")
    lora = jax.tree.map(jnp.asarray, lora_to_seed_tpu(init_lora(
        generator(torch.device("cpu"), args.seed + 1), base, r=16, alpha=32)))
    cfg = JM.TINY_LLAMA

    def loss_fn(p, batch, rng):
        merged = apply_lora(jbase, p["lora"])
        logits = JM.forward(merged, batch["input_ids"], cfg,
                            attn_mask=batch["attention_mask"], remat=True,
                            use_flash=True)
        return cross_entropy(logits[:, :-1], batch["labels"][:, 1:])

    params = {"lora": lora}
    opt = JOPT.adamw(JOPT.cosine_with_floor(args.lr, args.warmup, args.steps,
                                            args.min_lr_ratio),
                     b1=0.9, b2=0.95, eps=1e-5, weight_decay=args.weight_decay,
                     clip_norm=1.0, params=params)
    tr = Trainer(loss_fn, params, opt, auto_mesh(2, tp=2),
                 rules=LLAMA_TP_RULES,
                 cfg=TrainerConfig(grad_accum=args.grad_accum))
    stream = train_llm.batch_stream(args, ByteTextTokenizer())
    losses = []
    for i in range(args.steps):
        batch = {k: v.astype(np.int32) for k, v in next(stream).items()}
        losses.append(float(tr.step(batch, jax.random.PRNGKey(i))["loss"]))
    return losses


@pytest.fixture(scope="module")
def llm_tp2(tmp_path_factory):
    """``train_llm --tp 2`` in two gloo ranks, ``--tp 1`` in this process
    and seed_tpu's sharded Trainer, on one shard of SFT records and one fp32
    base (seed_tpu's init, ``--llm-ckpt``): in bf16 the row-parallel
    projections' two partial sums round once more than one product does."""
    import jax
    import jax.numpy as jnp
    from seed_tpu.models import llama as JM
    from test_torch_train_cli import qa_records, write_shard
    from seed_tpu_torch.train import train_llm
    from seed_tpu_torch.utils.checkpoint import save_checkpoint
    directory = tmp_path_factory.mktemp("llm_tp2")
    write_shard(directory / "data_000.tar", qa_records())
    jbase = JM.init_llama(jax.random.PRNGKey(0), JM.TINY_LLAMA, jnp.float32)
    save_checkpoint(str(directory / "base"), bridge.from_seed_tpu(
        jax.tree.map(np.asarray, jbase), "cpu"))
    one = train_llm.main(llm_argv(directory, "tp1"))
    ranks = run_ranks(train_llm_ranks, 2, directory / "ranks", str(directory))
    return (directory, ranks, [r["loss"] for r in one["log"] if "loss" in r],
            jax_tp2_losses(directory, jbase))


def test_train_llm_tp2_in_two_ranks_equals_tp1(llm_tp2):
    """``train_llm --tp 2`` in two gloo ranks (mesh fsdp=1 x tensor=2: both
    ranks read every shard) trains as ``--tp 1`` in one process does: the
    same losses (rtol 1e-4), rank 0 alone logs, and the saved adapters
    agree."""
    from seed_tpu_torch.utils.checkpoint import restore_checkpoint
    directory, got, want, _ = llm_tp2
    assert got[0]["step"] == got[1]["step"] == 3
    assert got[1]["losses"] == []                  # rank 0 logs
    np.testing.assert_allclose(got[0]["losses"], want, rtol=1e-4)
    a = dict(leaves_with_path(restore_checkpoint(
        str(directory / "tp1" / "step_3"), device="cpu")))
    b = dict(leaves_with_path(restore_checkpoint(
        str(directory / "tp2" / "step_3"), device="cpu")))
    assert set(a) == set(b)
    for path in a:
        np.testing.assert_allclose(b[path].float().numpy(),
                                   a[path].float().numpy(), atol=1e-4,
                                   err_msg=path)


def test_train_llm_tp2_matches_seed_tpu_sharded_trainer(llm_tp2):
    """``train_llm --tp 2``'s three losses against seed_tpu's Trainer on
    ``auto_mesh(2, tp=2)`` with LLAMA_TP_RULES on the same records, from
    the same base and adapters (rtol 1e-4, tests/test_train.py:223)."""
    _, got, _, want = llm_tp2
    assert len(want) == 3 and np.all(np.isfinite(want))
    np.testing.assert_allclose(got[0]["losses"], want, rtol=1e-4)


# ------------------------------------------------------------ train_tokenizer

def tok_argv(directory, out, stage=2):
    return ["--stage", str(stage), "--arch", "tiny", "--data",
            f"{directory}/imgs_*.tar", "--steps", "2", "--batch-size", "4",
            "--save-steps", "2", "--warmup", "0",
            "--output", f"{directory}/{out}", "--device", "cpu"]


def port_stage_configs():
    """The port's halves of test_torch_tokenizer_training's stage configs
    (importing that module would import JAX into every rank)."""
    import dataclasses
    from seed_tpu_torch.models import seed_tokenizer as TS
    from seed_tpu_torch.train import tokenizer_training as TTT
    base = TS.TINY_TOKENIZER
    s1 = TTT.Stage1Config(tokenizer=dataclasses.replace(
        base, qformer=dataclasses.replace(base.qformer, with_text=True,
                                          vocab_size=64, max_position=16)))
    s2 = TTT.Stage2Config(tokenizer=dataclasses.replace(
        base, with_recon_blocks=True, use_qformer_image=True))
    return s1, s2


def mesh_stage_step(params, loss_fn, pattern, batch, mesh):
    """One mesh Trainer step (frozen leaves masked, as train_tokenizer
    builds it) on this rank's slice of ``batch``; its metrics."""
    from seed_tpu_torch.train import optim as TOPT
    from seed_tpu_torch.train.trainer import Trainer
    opt = TOPT.masked_trainable(TOPT.adamw(lambda s: 1e-4, b2=0.999,
                                           eps=1e-8, params=params),
                                params, pattern)
    tr = Trainer(loss_fn, params, opt, device="cpu", mesh=mesh)
    return {k: float(v) for k, v in tr.step(TP.shard_batch(mesh, batch)).items()}


def train_tokenizer_ranks(rank, world, directory, stage1, stage2):
    """Both stages of ``train_tokenizer`` under FSDP over the two ranks,
    then one mesh Trainer step of each stage's loss on a fixed global batch
    (``stage1`` / ``stage2``: seed_tpu's weights and the batch)."""
    from seed_tpu_torch.train import tokenizer_training as TTT
    from seed_tpu_torch.train import train_tokenizer
    out = {}
    for stage in (1, 2):
        rec = train_tokenizer.main(tok_argv(directory, f"fsdp2_{stage}", stage))
        out[stage] = {"losses": [r["loss"] for r in rec["log"] if "loss" in r],
                      "step": rec["step"]}
    s1, s2 = port_stage_configs()
    mesh = TP.make_mesh(dp=1, fsdp=world, tp=1, device_type="cpu")
    B = stage1[1]["images"].shape[0]
    negatives = (torch.arange(B).roll(1), torch.arange(B).roll(-1))
    out["mesh_stage1"] = mesh_stage_step(
        bridge.from_seed_tpu(stage1[0], "cpu"),
        lambda p, b, r: TTT.stage1_total_loss(p, b, r, s1, negatives=negatives),
        TTT.STAGE1_TRAINABLE, stage1[1], mesh)
    out["mesh_stage2"] = mesh_stage_step(
        bridge.from_seed_tpu(stage2[0], "cpu"),
        lambda p, b, r: TTT.stage2_loss(p, b, r, s2),
        TTT.STAGE2_TRAINABLE, stage2[1], mesh)
    return out


def seed_tpu_stage_refs():
    """seed_tpu's weights, a global batch of 8 and its stage losses, their
    parts and the trainable gradients' norm, for each stage. Stage 1: rows
    0-3 (rank 0's) hold 24 real text tokens, rows 4-7 (rank 1's) 8, and
    ITM's negatives are rolled; stage 2 counts the codebook's usage."""
    import re
    import jax
    import jax.numpy as jnp
    from seed_tpu.models import qformer as JQ
    from seed_tpu.models import seed_tokenizer as JST
    from seed_tpu.parallel.partition import path_str
    from seed_tpu.train import tokenizer_training as JTT
    from test_torch_tokenizer_training import (jax_stage1_rolled, randn,
                                               stage1_configs, stage2_setup,
                                               text_batch)
    js1 = stage1_configs()[0]
    key = jax.random.PRNGKey(0)
    jp1 = {"tokenizer": JST.init_seed_tokenizer(key, js1.tokenizer),
           "head": JTT.init_stage1_head(jax.random.fold_in(key, 1), js1),
           "itm_head": JTT.init_itm_head(jax.random.fold_in(key, 3), js1),
           "lm_head": JQ.init_lm_head(jax.random.fold_in(key, 4),
                                      js1.tokenizer.qformer)}
    ids, pad = text_batch(8, 9, 64, 11)
    b1 = {"images": randn((8, 28, 28, 3), 10), "text_ids": ids.astype(np.int64),
          "text_pad": pad.astype(np.int64)}
    js2, _, jp2, _, _ = stage2_setup(True)
    b2 = {"images": randn((8, 28, 28, 3), 12),
          "clip_embeds": randn((8, 16), 13)}

    def norm(grads, pattern):
        flat = jax.tree_util.tree_flatten_with_path(grads)[0]
        return float(np.sqrt(sum(float(jnp.sum(jnp.square(g)))
                                 for p, g in flat
                                 if re.search(pattern, path_str(p)))))

    jb1 = {k: jnp.asarray(v) for k, v in b1.items()}
    loss1 = lambda p: jax_stage1_rolled(p, jb1)
    total, parts = loss1(jp1)
    g1 = jax.grad(lambda p: loss1(p)[0])(jp1)
    want1 = dict({k: float(v) for k, v in parts.items()}, loss=float(total),
                 grad_norm=norm(g1, JTT.STAGE1_TRAINABLE))
    jb2 = {k: jnp.asarray(v) for k, v in b2.items()}
    total, parts = JTT.stage2_loss(jp2, jb2, None, js2)
    g2 = jax.grad(lambda p: JTT.stage2_loss_scalar(p, jb2, None, js2))(jp2)
    want2 = dict({k: float(v) for k, v in parts.items()}, loss=float(total),
                 grad_norm=norm(g2, JTT.STAGE2_TRAINABLE))
    as_np = lambda t: jax.tree.map(np.asarray, t)
    return (as_np(jp1), b1), (as_np(jp2), b2), want1, want2


@pytest.fixture(scope="module")
def tokenizer_ranks(tmp_path_factory):
    from test_torch_train_cli import write_img_tar
    from seed_tpu_torch.train import train_tokenizer
    directory = tmp_path_factory.mktemp("tokenizer")
    for i in range(2):
        write_img_tar(directory / f"imgs_{i}.tar")
    stage1, stage2, want1, want2 = seed_tpu_stage_refs()
    got = run_ranks(train_tokenizer_ranks, 2, directory / "ranks",
                    str(directory), stage1, stage2)
    one = {stage: train_tokenizer.main(tok_argv(directory, f"one_{stage}",
                                                stage))
           for stage in (1, 2)}
    return directory, got, one, {1: want1, 2: want2}


@pytest.mark.parametrize("stage", [1, 2])
def test_train_tokenizer_in_two_ranks(tokenizer_ranks, stage):
    """``train_tokenizer`` in two gloo ranks trains under FSDP over both
    (seed_tpu's ``auto_mesh()``): each rank reads one of the two tars, the
    state is sharded, rank 0 logs, and the checkpoint holds the same
    trainable paths as a one-process run's, with finite losses (stage 1:
    ITC, ITM's hard negatives and the caption LM over the global batch;
    stage 2: the codebook path and its code-usage count). The values are
    held against seed_tpu in test_tokenizer_losses_under_mesh_match_seed_tpu."""
    from seed_tpu_torch.utils.checkpoint import restore_checkpoint
    directory, got, one, _ = tokenizer_ranks
    r0, r1 = got[0][stage], got[1][stage]
    assert r0["step"] == r1["step"] == 2 and r1["losses"] == []
    assert len(r0["losses"]) == 2 and np.all(np.isfinite(r0["losses"]))
    paths = lambda d: [p for p, _ in leaves_with_path(restore_checkpoint(
        str(directory / d / "step_2"), device="cpu"))]
    assert paths(f"fsdp2_{stage}") == paths(f"one_{stage}")
    assert one[stage]["step"] == 2


@pytest.mark.parametrize("stage", [1, 2])
def test_tokenizer_losses_under_mesh_match_seed_tpu(tokenizer_ranks, stage):
    """One mesh Trainer step (fsdp=2) of each stage's loss on a global
    batch of 8 rows, 4 per rank, against seed_tpu's loss on the same batch:
    stage 1 (ITC over the global batch, ITM on rolled global negatives,
    the caption LM over the valid tokens of both ranks, 24 on rank 0 and 8
    on rank 1) and stage 2 (VQ, recon, distill, and the codebook usage
    counted over both ranks' codes); the loss, its parts and the trainable
    gradients' norm within rtol 1e-4 (tests/test_train.py:223)."""
    _, got, _, want = tokenizer_ranks
    want = want[stage]
    for r in got:
        g = r[f"mesh_stage{stage}"]
        assert set(want) <= set(g), (sorted(want), sorted(g))
        for k, w in want.items():
            np.testing.assert_allclose(g[k], w, rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    if stage == 2:   # a share of the codebook: a ratio of counts
        assert 0 < want["codebook_usage"] <= 1
