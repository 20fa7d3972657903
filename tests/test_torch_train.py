"""seed_tpu_torch.train and seed_tpu_torch.utils.checkpoint against
seed_tpu.train (optax) on the CPU: schedules, losses, AdamW, the update
masks, LoRA, gradient accumulation, the train step on a tiny LLaMA + LoRA,
and checkpoints. Weights, gradients and batches come from numpy seeds and
reach both sides as the same numbers.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seed_tpu.models import llama as JM
from seed_tpu.train import lora as JLORA
from seed_tpu.train import losses as JLOSS
from seed_tpu.train import optim as JOPT
from seed_tpu.train import trainer as JTR
from seed_tpu.utils import checkpoint as JCK
from seed_tpu_torch import bridge
from seed_tpu_torch.models import llama as TM
from seed_tpu_torch.train import lora as TLORA
from seed_tpu_torch.train import losses as TLOSS
from seed_tpu_torch.train import optim as TOPT
from seed_tpu_torch.train import trainer as TTR
from seed_tpu_torch.utils import checkpoint as TCK
from seed_tpu_torch.utils.tree import leaves_with_path, tree_map


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def randn(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def to_torch(tree, dtype=None):
    """numpy tree -> torch tree (optionally cast)."""
    def leaf(a):
        t = torch.from_numpy(np.array(a, copy=True))
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t
    return jax.tree.map(leaf, tree)


def to_jax(tree, dtype=None):
    def leaf(a):
        a = jnp.asarray(a)
        return a.astype(dtype) if dtype is not None and jnp.issubdtype(
            a.dtype, jnp.floating) else a
    return jax.tree.map(leaf, tree)


# ------------------------------------------------------------- schedules

SCHEDULES = {
    "cosine_with_floor": (dict(base_lr=1.5e-4, warmup_steps=10,
                               total_steps=100, min_lr_ratio=0.05),),
    "warmup_cosine": (dict(base_lr=1e-4, warmup_steps=20, total_steps=200,
                           min_lr=1e-5, warmup_start_lr=1e-6),),
    "warmup_step_decay": (dict(base_lr=1e-4, warmup_steps=20,
                               steps_per_epoch=50, min_lr=1e-5,
                               decay_rate=0.5, warmup_start_lr=1e-6),),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_on_a_grid_of_steps(name):
    """The port computes in Python doubles, seed_tpu in fp32: 1e-5 relative."""
    (kwargs,) = SCHEDULES[name]
    want = getattr(JOPT, name)(**kwargs)
    got = getattr(TOPT, name)(**kwargs)
    for step in (0, 1, 5, 9, 10, 11, 19, 20, 21, 49, 50, 51, 99, 100, 150,
                 199, 200, 400):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-5,
                                   atol=1e-12, err_msg=f"step {step}")
    assert got(0) == 0.0 if name == "cosine_with_floor" else got(0) > 0


# ---------------------------------------------------------------- losses

def test_cross_entropy_ignores_minus_100():
    logits = randn((2, 7, 11), 0) * 3
    labels = np.random.RandomState(1).randint(0, 11, (2, 7))
    labels[0, :3] = -100
    labels[1, 5:] = -100
    want = float(JLOSS.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = TLOSS.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    all_ignored = torch.full((2, 7), -100)
    assert float(TLOSS.cross_entropy(torch.from_numpy(logits), all_ignored)) == 0.0


def test_cross_entropy_bf16_logits_are_upcast():
    logits = randn((1, 5, 9), 2)
    labels = np.random.RandomState(3).randint(0, 9, (1, 5))
    want = float(JLOSS.cross_entropy(jnp.asarray(logits, jnp.bfloat16),
                                     jnp.asarray(labels)))
    got = TLOSS.cross_entropy(torch.from_numpy(logits).bfloat16(),
                              torch.from_numpy(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_next_token_loss_shifts_labels():
    logits = randn((2, 6, 8), 4)
    ids = np.random.RandomState(5).randint(0, 8, (2, 6))
    labels = ids.copy()
    labels[:, :2] = -100
    for lab in (None, labels):
        want = float(JLOSS.next_token_loss(
            jnp.asarray(logits), jnp.asarray(ids),
            None if lab is None else jnp.asarray(lab)))
        got = TLOSS.next_token_loss(
            torch.from_numpy(logits), torch.from_numpy(ids),
            None if lab is None else torch.from_numpy(lab))
        np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_info_nce_cosine_recon_and_mse():
    a, b = randn((6, 16), 6), randn((6, 16), 7)
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    pairs = [
        (JLOSS.info_nce(jnp.asarray(a), jnp.asarray(b), 0.07),
         TLOSS.info_nce(torch.from_numpy(a), torch.from_numpy(b), 0.07)),
        (JLOSS.cosine_recon_loss(jnp.asarray(a * 3), jnp.asarray(b)),
         TLOSS.cosine_recon_loss(torch.from_numpy(a * 3), torch.from_numpy(b))),
        (JLOSS.mse_loss(jnp.asarray(a), jnp.asarray(b)),
         TLOSS.mse_loss(torch.from_numpy(a), torch.from_numpy(b))),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    with pytest.raises(NotImplementedError, match="axis_name"):
        TLOSS.info_nce(torch.from_numpy(a), torch.from_numpy(b), 0.07,
                       axis_name="data")


# ----------------------------------------------------------------- AdamW

def small_tree(seed):
    return {"proj": {"kernel": randn((4, 3), seed), "bias": randn((3,), seed + 1)},
            "embed_tokens": {"embedding": randn((6, 4), seed + 2)},
            "norm": {"scale": randn((4,), seed + 3)},
            "lm_head": {"kernel": randn((4, 6), seed + 4)}}


def run_optimizers(jopt, topt, dtype, steps=5, grad_scale=1.0):
    """Feed both optimizers the same gradients for ``steps`` steps; returns
    (seed_tpu params, port params, port state)."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jp, tp = to_jax(small_tree(0), jdt), to_torch(small_tree(0), dtype)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for i in range(steps):
        g = jax.tree.map(lambda a: a * grad_scale, small_tree(100 + 10 * i))
        ju, jstate = jopt.update(to_jax(g, jdt), jstate, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tstate = topt.update(to_torch(g, dtype), tstate, tp)
        tp = TOPT.apply_updates(tp, tu)
    return jp, tp, tstate


def assert_trees_close(got, want, dtype):
    """fp32: op order only (1e-6). bf16: every optimizer op rounds to bf16 on
    both sides but XLA may fuse two roundings into one: 2 bf16 ulps (2**-6
    relative, 2**-9 absolute for entries near zero)."""
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32
           else dict(rtol=2.0 ** -6, atol=2.0 ** -9))
    want = dict(leaves_with_path(jax.tree.map(np.asarray, jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float32), want))))
    for name, leaf in leaves_with_path(got):
        assert leaf.dtype == dtype, name
        np.testing.assert_allclose(f32(leaf), want[name], err_msg=name, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("clip", ["clip_active", "clip_inactive"])
def test_adamw_five_steps_match_optax(dtype, clip):
    """Warm-up schedule, weight decay with the no-decay mask, global-norm
    clip 1.0 with gradients far above it (active) or far below (inactive)."""
    kwargs = dict(b2=0.95, eps=1e-5, weight_decay=0.05, clip_norm=1.0)
    sched = dict(base_lr=1e-2, warmup_steps=2, total_steps=10, min_lr_ratio=0.05)
    jopt = JOPT.adamw(JOPT.cosine_with_floor(**sched), params=small_tree(0),
                      **kwargs)
    topt = TOPT.adamw(TOPT.cosine_with_floor(**sched), params=small_tree(0),
                      **kwargs)
    scale = 10.0 if clip == "clip_active" else 0.01
    jp, tp, tstate = run_optimizers(jopt, topt, dtype, grad_scale=scale)
    assert_trees_close(tp, jp, dtype)
    assert tstate["count"] == 5
    for name, m in leaves_with_path(tstate["mu"]) + leaves_with_path(tstate["nu"]):
        assert m.dtype == dtype, name     # moments take the leaf's dtype


def test_adamw_first_step_of_a_warmup_changes_nothing():
    """optax reads the schedule at the count before the increment: lr(0) = 0."""
    opt = TOPT.adamw(TOPT.cosine_with_floor(1e-2, 3, 10), weight_decay=0.1,
                     params=small_tree(0))
    p = to_torch(small_tree(0))
    u, state = opt.update(to_torch(small_tree(1)), opt.init(p), p)
    assert all(not leaf.any() for _, leaf in leaves_with_path(u))
    assert state["count"] == 1 and any(
        leaf.any() for _, leaf in leaves_with_path(state["mu"]))


def test_adamw_clip_factor_is_clip_over_norm_without_epsilon():
    """A gradient of norm exactly 2 x clip is halved exactly (torch's
    clip_grad_norm_ would divide by norm + 1e-6)."""
    opt = TOPT.adamw(lambda step: 1.0, b1=0.0, b2=0.0, eps=0.0, clip_norm=1.0)
    p = {"w": torch.zeros(4)}
    g = {"w": torch.tensor([2.0, 0.0, 0.0, 0.0])}
    _, state = opt.update(g, opt.init(p), p)
    assert state["mu"]["w"][0].item() == 1.0


def test_adamw_decay_mask_skips_one_d_bias_and_embedding_leaves():
    opt = TOPT.adamw(lambda step: 1.0, weight_decay=0.5, clip_norm=None,
                     params=small_tree(0))
    p = to_torch(small_tree(0))
    zeros = tree_map(torch.zeros_like, p)
    u, _ = opt.update(zeros, opt.init(p), p)
    moved = {name for name, leaf in leaves_with_path(u) if leaf.any()}
    assert moved == {"proj/kernel", "lm_head/kernel"}
    # without params every leaf decays, as in seed_tpu
    every = TOPT.adamw(lambda step: 1.0, weight_decay=0.5, clip_norm=None)
    u, _ = every.update(zeros, every.init(p), p)
    assert all(leaf.any() for _, leaf in leaves_with_path(u))


@pytest.mark.parametrize("dtype", [torch.float32])
def test_learnable_image_embeddings_only(dtype):
    """Rows 0..2 are the old vocabulary, row 5 is padding: their updates are
    exactly zero although weight decay acts on lm_head; rows 3..4 match
    seed_tpu."""
    kwargs = dict(b2=0.95, eps=1e-5, weight_decay=0.05, clip_norm=1.0)
    jopt = JOPT.learnable_image_embeddings_only(
        JOPT.adamw(JOPT.cosine_with_floor(1e-2, 0, 10), params=small_tree(0),
                   **kwargs), 3, vocab_size=5)
    topt = TOPT.learnable_image_embeddings_only(
        TOPT.adamw(TOPT.cosine_with_floor(1e-2, 0, 10), params=small_tree(0),
                   **kwargs), 3, vocab_size=5)
    jp, tp, _ = run_optimizers(jopt, topt, dtype, grad_scale=10.0)
    assert_trees_close(tp, jp, dtype)
    start = to_torch(small_tree(0))
    frozen = [0, 1, 2, 5]
    assert torch.equal(tp["embed_tokens"]["embedding"][frozen],
                       start["embed_tokens"]["embedding"][frozen])
    assert torch.equal(tp["lm_head"]["kernel"][:, frozen],
                       start["lm_head"]["kernel"][:, frozen])
    assert not torch.equal(tp["lm_head"]["kernel"][:, 3:5],
                           start["lm_head"]["kernel"][:, 3:5])


def test_masked_trainable_pins_frozen_leaves():
    """Frozen leaves stay bit-identical under weight decay, carry no moments
    and stay out of the clip's norm; trained leaves match seed_tpu."""
    kwargs = dict(b2=0.95, eps=1e-5, weight_decay=0.05, clip_norm=1.0)
    pattern = r"^(proj|norm)/"
    jopt = JOPT.masked_trainable(
        JOPT.adamw(JOPT.cosine_with_floor(1e-2, 0, 10), params=small_tree(0),
                   **kwargs), small_tree(0), pattern)
    topt = TOPT.masked_trainable(
        TOPT.adamw(TOPT.cosine_with_floor(1e-2, 0, 10), params=small_tree(0),
                   **kwargs), small_tree(0), pattern)
    jp, tp, tstate = run_optimizers(jopt, topt, torch.float32, grad_scale=10.0)
    assert_trees_close(tp, jp, torch.float32)
    start = to_torch(small_tree(0))
    assert torch.equal(tp["lm_head"]["kernel"], start["lm_head"]["kernel"])
    assert torch.equal(tp["embed_tokens"]["embedding"],
                       start["embed_tokens"]["embedding"])
    assert tstate["mu"]["lm_head"]["kernel"] is None
    assert not torch.equal(tp["proj"]["kernel"], start["proj"]["kernel"])


# ------------------------------------------------------------------ LoRA

JCFG, TCFG = JM.TINY_LLAMA, TM.TINY_LLAMA
PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
               "down_proj")


@pytest.fixture(scope="module")
def tiny():
    """seed_tpu tiny LLaMA and LoRA (B made non-zero), and both carried to
    the port."""
    jbase = JM.init_llama(jax.random.PRNGKey(0), JCFG, jnp.float32)
    jlora = JLORA.init_lora(jax.random.PRNGKey(1), jbase, r=4, alpha=8)
    jlora["adapters"] = {
        name: {"a": ad["a"],
               "b": jnp.asarray(randn(ad["b"].shape, i) * 0.02)}
        for i, (name, ad) in enumerate(sorted(jlora["adapters"].items()))}
    tbase = bridge.from_seed_tpu(jax.tree.map(np.asarray, jbase), device="cpu")
    tlora = bridge.lora_from_seed_tpu(jax.tree.map(np.asarray, jlora),
                                      device="cpu")
    return jbase, jlora, tbase, tlora


def test_init_lora_adapts_the_seven_projections_and_starts_as_identity(tiny):
    _, _, tbase, _ = tiny
    gen = torch.Generator().manual_seed(0)
    lora = TLORA.init_lora(gen, tbase, r=4, alpha=8)
    assert sorted(lora["adapters"]) == sorted(
        f"layers/{i}/{p}/kernel" for i in range(TCFG.layers) for p in PROJECTIONS)
    assert float(lora["scale"]) == 2.0 and lora["scale"].dtype == torch.float32
    for name, ad in lora["adapters"].items():
        kernel = tbase["layers"][int(name.split("/")[1])][name.split("/")[2]]["kernel"]
        assert ad["a"].shape == (kernel.shape[0], 4) and ad["a"].dtype == torch.float32
        assert ad["b"].shape == (4, kernel.shape[1]) and not ad["b"].any()
        assert 0.01 < ad["a"].std() < 0.03
    merged = TLORA.apply_lora(tbase, lora)
    for (name, a), (_, b) in zip(leaves_with_path(merged), leaves_with_path(tbase)):
        assert torch.equal(a, b), name
    assert merged["norm"]["scale"] is tbase["norm"]["scale"]   # passed on, not copied
    again = TLORA.init_lora(torch.Generator().manual_seed(0), tbase, r=4, alpha=8)
    assert torch.equal(again["adapters"]["layers/0/q_proj/kernel"]["a"],
                       lora["adapters"]["layers/0/q_proj/kernel"]["a"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_merge_values_match(tiny, dtype):
    """fp32 merge, cast back to the kernel's dtype: fp32 1e-6; bf16 kernels
    equal bit for bit (one rounding of the same fp32 sum, up to its ties)."""
    jbase, jlora, tbase, tlora = tiny
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = JLORA.merge_lora_weights(to_jax(jbase, jdt), jlora)
    got = TLORA.merge_lora_weights(tree_map(lambda t: t.to(dtype), tbase), tlora)
    for i in range(TCFG.layers):
        for proj in PROJECTIONS:
            g = got["layers"][i][proj]["kernel"]
            w = f32(want["layers"][proj]["kernel"][i])
            assert g.dtype == dtype
            if dtype == torch.float32:
                np.testing.assert_allclose(f32(g), w, atol=1e-6)
                assert not torch.equal(g, tbase["layers"][i][proj]["kernel"])
            else:
                assert (f32(g) == w).mean() > 0.999
    assert torch.equal(got["embed_tokens"]["embedding"],
                       tbase["embed_tokens"]["embedding"].to(dtype))


def test_lora_scale_is_not_differentiated(tiny):
    _, _, tbase, tlora = tiny
    live = tree_map(lambda t: t.clone().requires_grad_(), tlora)
    merged = TLORA.apply_lora(tbase, live)
    sum(leaf.sum() for _, leaf in leaves_with_path(merged)).backward()
    assert live["scale"].grad is None
    assert live["adapters"]["layers/1/down_proj/kernel"]["b"].grad.abs().sum() > 0


def test_split_trainable_round_trip(tiny):
    jbase, _, tbase, _ = tiny
    tr, fr, combine = TLORA.split_trainable(tbase)
    jtr, _, _ = JLORA.split_trainable(jbase)
    names = {n for n, _ in leaves_with_path(tr)}
    assert "embed_tokens/embedding" in names and "lm_head/kernel" in names
    assert "layers/0/input_layernorm/scale" in names
    assert "layers/0/q_proj/kernel" not in names
    # the same leaves as seed_tpu picks (its layers are stacked: L per leaf).
    # DEFAULT_SAVE's "/norm" needs a parent, so the final norm at the root of
    # the LLaMA tree is picked by neither side.
    jnames = {JLORA.path_str(p) for p, leaf in
              jax.tree_util.tree_flatten_with_path(jtr)[0]}
    assert jnames == {n if not n.startswith("layers/") else
                      "layers/" + n.split("/", 2)[2] for n in names}
    assert "norm/scale" not in names
    assert not names & {n for n, _ in leaves_with_path(fr)}
    back = combine(tr, fr)
    for (name, a), (_, b) in zip(leaves_with_path(back), leaves_with_path(tbase)):
        assert a is b, name


# ------------------------------------------------------------ train step

def batches(n, B, N, seed, accum=None):
    """Seeded batches in seed_tpu.data.collate's layout: right-padded,
    labels -100 on the padding."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        shape = (B, N) if accum is None else (accum, B, N)
        ids = rs.randint(3, 270, shape).astype(np.int32)
        lengths = rs.randint(N // 2, N + 1, shape[:-1])
        mask = (np.arange(N) < lengths[..., None]).astype(np.int32)
        out.append({"input_ids": ids * mask, "attention_mask": mask,
                    "labels": np.where(mask == 1, ids, -100).astype(np.int32)})
    return out


def losses_for(jbase, tbase):
    def jloss(lora, batch, rng):
        logits = JM.forward(JLORA.apply_lora(jbase, lora), batch["input_ids"],
                            JCFG, attn_mask=batch["attention_mask"],
                            remat=True, use_flash=True)
        return JLOSS.cross_entropy(logits[:, :-1], batch["labels"][:, 1:])

    def tloss(lora, batch, rng):
        logits = TM.forward(TLORA.apply_lora(tbase, lora), batch["input_ids"],
                            TCFG, attn_mask=batch["attention_mask"],
                            remat=True, use_flash=True)
        return TLOSS.cross_entropy(logits[:, :-1], batch["labels"][:, 1:])

    return jloss, tloss


def torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def test_grad_accumulation_two_by_two_equals_one_batch_of_four(tiny):
    """Equal-length rows, so the mean over 2 micro-batches of 2 is the mean
    over 4: loss and every gradient agree to fp32 sum order (1e-6)."""
    _, _, tbase, tlora = tiny
    _, tloss = losses_for(None, tbase)
    ids = np.random.RandomState(0).randint(3, 270, (4, 16))
    whole = {"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": ids}
    split = {k: v.reshape(2, 2, 16) for k, v in whole.items()}
    opt = TOPT.adamw(lambda step: 1e-3, params=tlora)
    state = TTR.TrainState(0, tlora, opt.init(tlora))
    s1, m1 = TTR.make_train_step(tloss, opt, 1)(state, torch_batch(whole), None)
    s2, m2 = TTR.make_train_step(tloss, opt, 2)(state, torch_batch(split), None)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]),
                               rtol=1e-5)
    for (name, a), (_, b) in zip(leaves_with_path(s2.params),
                                 leaves_with_path(s1.params)):
        np.testing.assert_allclose(f32(a), f32(b), atol=1e-6, err_msg=name)
    assert s2.step == 1 and state.step == 0


@pytest.mark.parametrize("accum", [1, 2])
def test_three_train_steps_match_seed_tpu(tiny, accum):
    """make_train_step on the tiny LLaMA + LoRA (adapters trained, base
    closed over), seed_tpu's called directly without a mesh. Loss and
    pre-clip grad_norm per step within 1e-5 relative; adapters after three
    steps within 1e-5 absolute (Adam divides by sqrt(v): fp32 sum-order
    differences of the gradients are amplified where v is small)."""
    jbase, jlora, tbase, tlora = tiny
    jloss, tloss = losses_for(jbase, tbase)
    sched = dict(base_lr=1e-3, warmup_steps=1, total_steps=3, min_lr_ratio=0.05)
    kwargs = dict(b2=0.95, eps=1e-5, weight_decay=0.05, clip_norm=1.0)
    jopt = JOPT.adamw(JOPT.cosine_with_floor(**sched), params=jlora, **kwargs)
    topt = TOPT.adamw(TOPT.cosine_with_floor(**sched), params=tlora, **kwargs)
    jstep = jax.jit(JTR.make_train_step(jloss, jopt, accum))
    tstep = TTR.make_train_step(tloss, topt, accum)
    jstate = JTR.TrainState(jnp.zeros((), jnp.int32), jlora, jopt.init(jlora))
    tstate = TTR.TrainState(0, tlora, topt.init(tlora))
    data = batches(3, 2, 24, seed=accum, accum=None if accum == 1 else accum)
    for i, batch in enumerate(data):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch),
                           jax.random.PRNGKey(i))
        tstate, tm = tstep(tstate, torch_batch(batch), None)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=f"step {i} {key}")
        if i == 0:      # lr(0) = 0: the first step moves nothing
            for (name, a), (_, b) in zip(leaves_with_path(tstate.params),
                                         leaves_with_path(tlora)):
                assert torch.equal(a, b), name
    want = bridge.lora_from_seed_tpu(jax.tree.map(np.asarray, jstate.params),
                                     device="cpu")
    moved = 0
    for (name, got), (_, w), (_, start) in zip(
            leaves_with_path(tstate.params), leaves_with_path(want),
            leaves_with_path(tlora)):
        np.testing.assert_allclose(f32(got), f32(w), atol=1e-5, err_msg=name)
        moved += int(not torch.equal(got, start))
    assert moved == 2 * 7 * TCFG.layers      # every A and B; the scale stays
    assert float(tstate.params["scale"]) == 2.0 and tstate.step == 3


def test_trainer_save_restore_continue_equals_uninterrupted(tiny, tmp_path):
    _, _, tbase, tlora = tiny
    _, tloss = losses_for(None, tbase)
    data = batches(4, 2, 16, seed=7, accum=2)

    def fresh():
        opt = TOPT.adamw(TOPT.cosine_with_floor(1e-3, 1, 4, 0.05),
                         weight_decay=0.05, params=tlora)
        return TTR.Trainer(tloss, tlora, opt, TTR.TrainerConfig(grad_accum=2),
                           device="cpu")

    straight = fresh()
    logged = []
    last = straight.train(iter(data), 4, log_fn=lambda s, m: logged.append(s))
    assert straight.state.step == 4 and logged == [1, 4]
    assert set(last) == {"loss", "grad_norm"} and np.isfinite(last["loss"])

    first = fresh()
    first.train(iter(data[:2]), 2)
    mgr = TCK.CheckpointManager(str(tmp_path / "state"), max_to_keep=2)
    path = first.save_state(mgr)
    assert path.endswith("step_2") and mgr.latest_step() == 2
    second = fresh()
    assert second.restore_state(mgr) == 2 and second.state.step == 2
    resumed = second.train(iter(data[2:]), 2)
    assert resumed == last
    for (name, a), (_, b) in zip(leaves_with_path(second.state.params),
                                 leaves_with_path(straight.state.params)):
        assert torch.equal(a, b), name
    assert second.state.opt_state["count"] == 4
    empty = TCK.CheckpointManager(str(tmp_path / "none"))
    assert fresh().restore_state(empty) is None


def test_trainer_defaults_to_the_card(tiny):
    _, _, tbase, tlora = tiny
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TTR.Trainer(lambda p, b, r: None, tlora, TOPT.adamw(lambda s: 1e-3))


# ------------------------------------------------------------ checkpoints

def test_checkpoint_round_trip_layout_and_retention(tmp_path):
    tree = {"a": {"w": torch.arange(6.0).reshape(2, 3).bfloat16()},
            "layers": [{"k": torch.ones(2)}, {"k": torch.zeros(2)}],
            "step": 3, "absent": None}
    TCK.save_checkpoint(str(tmp_path / "one"), tree)
    back = TCK.restore_checkpoint(str(tmp_path / "one"), device="cpu")
    assert back["step"] == 3 and back["absent"] is None
    assert back["a"]["w"].dtype == torch.bfloat16
    assert torch.equal(back["a"]["w"], tree["a"]["w"])
    assert torch.equal(back["layers"][1]["k"], tree["layers"][1]["k"])
    with pytest.raises(FileExistsError):
        TCK.save_checkpoint(str(tmp_path / "one"), tree, force=False)
    bad = dict(tree, a={"w": torch.zeros(3, 2).bfloat16()})
    with pytest.raises(ValueError, match="a/w"):
        TCK.restore_checkpoint(str(tmp_path / "one"), template=bad)

    mgr = TCK.CheckpointManager(str(tmp_path / "run"), max_to_keep=2)
    jmgr = JCK.CheckpointManager(str(tmp_path / "jrun"), max_to_keep=2)
    for step in (1, 2, 3):
        mgr.save(step, dict(tree, step=step), is_best=step == 2)
        jmgr.save(step, {"x": jnp.zeros(2)}, is_best=step == 2)
    names = lambda d: sorted(p.name for p in Path(d).iterdir())
    assert names(mgr.dir) == names(jmgr.dir) == ["best", "step_2", "step_3"]
    step, latest = mgr.restore_latest(tree)
    assert step == 3 and latest["step"] == 3
    assert TCK.restore_checkpoint(str(tmp_path / "run" / "best"),
                                  device="cpu")["step"] == 2


def test_filter_tree_and_merge_tree_match():
    base = small_tree(0)
    pattern = r"(proj|norm)/"
    jf = JCK.filter_tree(to_jax(base), pattern)
    tf = TCK.filter_tree(to_torch(base), pattern)
    kept = {n for n, _ in leaves_with_path(tf)}
    assert kept == {"proj/kernel", "proj/bias", "norm/scale"}
    assert len(jax.tree.leaves(jf)) == len(kept)
    overlay = TCK.filter_tree(to_torch(small_tree(9)), pattern)
    merged = TCK.merge_tree(to_torch(base), overlay)
    jmerged = JCK.merge_tree(to_jax(base),
                             JCK.filter_tree(to_jax(small_tree(9)), pattern))
    for name, leaf in leaves_with_path(merged):
        want = jmerged
        for key in name.split("/"):
            want = want[key]
        np.testing.assert_array_equal(f32(leaf), f32(want), err_msg=name)
    with pytest.raises(ValueError, match="shape mismatch at proj/bias"):
        TCK.merge_tree(to_torch(base), {"proj": {"bias": torch.zeros(5)}})


def test_train_and_utils_import_neither_jax_nor_seed_tpu():
    code = textwrap.dedent("""
        import sys
        import seed_tpu_torch.train, seed_tpu_torch.utils
        import seed_tpu_torch.utils.tree, seed_tpu_torch.ops.flash_attention
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "optax", "orbax", "seed_tpu")]
        assert not bad, bad
        print("isolated")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "isolated"
