"""SEED tokenizer training of seed_tpu_torch against seed_tpu, on the CPU in
fp32, on seed_tpu's own weights carried across by seed_tpu_torch.bridge:
the Q-Former's text, joint and caption paths and LM head, the
straight-through VQ, the CLIP target tower, the stage-1 and stage-2 losses
and their gradients, and the freeze mask.

Contracts: forward values within 1e-5 (fp32, sums in another order); the VQ
loss within 1e-6 and its ids equal; gradients within 1e-4. ITM's hard
negatives are sampled, so the Sampling contract holds: the masked logits
they are drawn from are compared (1e-6), the loss only under fixed
negatives, never the draws.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seed_tpu.models import qformer as JQ
from seed_tpu.models import quantizer as JVQ
from seed_tpu.models import seed_tokenizer as JST
from seed_tpu.models import vit as JV
from seed_tpu.train import tokenizer_training as JTT
from seed_tpu_torch import bridge
from seed_tpu_torch.models import qformer as TQ
from seed_tpu_torch.models import quantizer as TVQ
from seed_tpu_torch.models import seed_tokenizer as TST
from seed_tpu_torch.models import vit as TV
from seed_tpu_torch.train import optim as TOPT
from seed_tpu_torch.train import tokenizer_training as TTT
from seed_tpu_torch.train.trainer import Trainer
from seed_tpu_torch.utils.tree import leaves_with_path

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


def port(tree):
    """seed_tpu tree -> the port's tensors on the CPU."""
    return bridge.from_seed_tpu(jax.tree.map(np.asarray, tree), device="cpu")


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


def close(got, want, tol=FWD, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=msg, **tol)


def randn(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def text_batch(B, T, vocab, seed):
    """Right-padded text: ids in [3, vocab), 1 = real token, row lengths
    from T down to 2."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(3, vocab, (B, T)).astype(np.int32)
    lens = np.maximum(2, T - np.arange(B) * 2)
    pad = (np.arange(T)[None] < lens[:, None]).astype(np.int32)
    return ids * pad, pad


# ------------------------------------------------------------- Q-Former

JQCFG = dataclasses.replace(JQ.TINY_QFORMER, with_text=True)
TQCFG = dataclasses.replace(TQ.TINY_QFORMER, with_text=True)


@pytest.fixture(scope="module")
def qformer():
    jp = JQ.init_qformer(jax.random.PRNGKey(0), JQCFG)
    jhead = JQ.init_lm_head(jax.random.PRNGKey(1), JQCFG)
    jhead["bias"] = jnp.asarray(randn(jhead["bias"].shape, 5, 0.1))
    feats = randn((3, 10, JQCFG.encoder_width), 2)
    ids, pad = text_batch(3, 7, JQCFG.vocab_size, 3)
    return jp, jhead, port(jp), port(jhead), feats, ids, pad


def test_qformer_with_text_tree_matches(qformer):
    jp, _, tp, _, *_ = qformer
    want = {p for p, _ in leaves_with_path(port(jp))}
    got = TQ.init_qformer(torch.Generator().manual_seed(0), TQCFG,
                          device="cpu")
    assert {p for p, _ in leaves_with_path(got)} == want
    for (p, a), (_, b) in zip(sorted(leaves_with_path(got)),
                              sorted(leaves_with_path(tp))):
        assert a.shape == b.shape, p


def test_masks_equal():
    _, pad = text_batch(3, 7, 64, 3)
    np.testing.assert_array_equal(
        TQ.seed_causal_mask(8, 7, t(pad)).numpy(),
        np.asarray(JQ.seed_causal_mask(8, 7, jnp.asarray(pad))))
    np.testing.assert_array_equal(TQ.seed_causal_mask(8, 7).numpy(),
                                  np.asarray(JQ.seed_causal_mask(8, 7)))
    np.testing.assert_array_equal(TQ.seed_caption_mask(8, 7).numpy(),
                                  np.asarray(JQ.seed_caption_mask(8, 7)))


def test_qformer_text_apply(qformer):
    jp, _, tp, _, _, ids, pad = qformer
    close(TQ.qformer_text_apply(tp, t(ids), TQCFG, t(pad)),
          JQ.qformer_text_apply(jp, jnp.asarray(ids), JQCFG, jnp.asarray(pad)))


def test_qformer_joint_apply(qformer):
    jp, _, tp, _, feats, ids, pad = qformer
    close(TQ.qformer_apply(tp, t(feats), TQCFG, text_ids=t(ids),
                           text_pad=t(pad)),
          JQ.qformer_apply(jp, jnp.asarray(feats), JQCFG,
                           text_ids=jnp.asarray(ids),
                           text_pad=jnp.asarray(pad)))
    # the query path alone on the same tree
    close(TQ.qformer_apply(tp, t(feats), TQCFG),
          JQ.qformer_apply(jp, jnp.asarray(feats), JQCFG))


def test_qformer_caption_apply_and_lm_head(qformer):
    jp, jhead, tp, thead, feats, ids, pad = qformer
    th = TQ.qformer_caption_apply(tp, t(feats), t(ids), TQCFG, t(pad))
    jh = JQ.qformer_caption_apply(jp, jnp.asarray(feats), jnp.asarray(ids),
                                  JQCFG, jnp.asarray(pad))
    close(th, jh)
    close(TQ.lm_head_apply(thead, tp["embeddings"]["word_embeddings"], th,
                           TQCFG),
          JQ.lm_head_apply(jhead, jp["embeddings"]["word_embeddings"], jh,
                           JQCFG))


CAPTION_LEN = 8


def caption_eos(qformer):
    """An eos id that row 0 emits at its third step, so that the
    generators' eos-stickiness is exercised."""
    _, _, tp, thead, feats, _, _ = qformer
    toks = TQ.qformer_generate_caption(tp, thead, t(feats), TQCFG, bos_id=1,
                                       eos_id=0, max_len=CAPTION_LEN)
    return int(toks[0, 3])


@pytest.mark.parametrize("cached", [False, True], ids=["recompute", "cached"])
def test_caption_generators_match_seed_tpu(qformer, cached):
    jp, jhead, tp, thead, feats, _, _ = qformer
    eos = caption_eos(qformer)
    jgen = (JQ.qformer_generate_caption_cached if cached
            else JQ.qformer_generate_caption)
    tgen = (TQ.qformer_generate_caption_cached if cached
            else TQ.qformer_generate_caption)
    want = jax.jit(jgen, static_argnums=(3, 4, 5, 6))(
        jp, jhead, jnp.asarray(feats), JQCFG, 1, eos, CAPTION_LEN)
    got = tgen(tp, thead, t(feats), TQCFG, bos_id=1, eos_id=eos,
               max_len=CAPTION_LEN)
    assert got.dtype == torch.int32 and got.shape == (3, CAPTION_LEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    row = got[0].tolist()
    assert row[0] == 1 and row[3:] == [eos] * (CAPTION_LEN - 3)


def test_cached_caption_generator_equals_recompute(qformer):
    _, _, tp, thead, feats, _, _ = qformer
    for eos in (0, caption_eos(qformer)):
        a = TQ.qformer_generate_caption(tp, thead, t(feats), TQCFG, 1, eos,
                                        CAPTION_LEN)
        b = TQ.qformer_generate_caption_cached(tp, thead, t(feats), TQCFG, 1,
                                               eos, CAPTION_LEN)
        assert torch.equal(a, b)


def test_caption_step_hidden_equals_joint_forward(qformer):
    """Each cached step's hidden is the text row of the joint caption pass
    (the queries never see the text, and the text sees only its past)."""
    jp, _, tp, _, feats, ids, _ = qformer
    T = ids.shape[1]
    full = TQ.qformer_caption_apply(tp, t(feats), t(ids), TQCFG)
    cache = TQ.qformer_caption_prefix(tp, t(feats), TQCFG, T)
    jcache = JQ.qformer_caption_prefix(jp, jnp.asarray(feats), JQCFG, T)
    for layer, jlayer in zip(cache, jcache):
        close(layer["k"], jlayer["k"])
    for i in range(T):
        hidden, cache = TQ.qformer_caption_step(tp, cache, t(ids[:, i]), i,
                                                TQCFG)
        close(hidden, full[:, i].detach(), msg=f"text position {i}")


# ------------------------------------------------------------------- VQ

def test_quantize_straight_through():
    cb = JVQ.init_codebook(jax.random.PRNGKey(0), 64, 8)
    z = randn((2, 8, 8), 4, 0.02)
    for legacy in (True, False):
        jr = JVQ.quantize(cb, jnp.asarray(z), beta=0.25, legacy=legacy)
        tr = TVQ.quantize(port(cb), t(z), beta=0.25, legacy=legacy)
        np.testing.assert_array_equal(tr.indices.numpy(), np.asarray(jr.indices))
        close(tr.quantized, jr.quantized)
        close(tr.loss, jr.loss, dict(rtol=1e-6, atol=1e-6))
    # the straight-through estimator: d(sum quantized)/dz = 1
    zt = t(z).requires_grad_()
    TVQ.quantize(port(cb), zt).quantized.sum().backward()
    assert torch.equal(zt.grad, torch.ones_like(zt))


# ----------------------------------------------------------------- CLIP

def test_clip_image_embed_with_ln_pre():
    jcfg = dataclasses.replace(JV.TINY_VIT, qkv_bias="full", ln_pre=True,
                               patch_bias=False, act="quick_gelu")
    tcfg = dataclasses.replace(TV.TINY_VIT, qkv_bias="full", ln_pre=True,
                               patch_bias=False, act="quick_gelu")
    jv = JV.init_vit(jax.random.PRNGKey(0), jcfg)
    jh = JV.init_clip_vision_projection(jax.random.PRNGKey(1), jcfg, 16)
    for tree, name, seed in ((jv, "ln_pre", 6), (jh, "ln_post", 7)):
        tree[name] = {"scale": jnp.asarray(1 + randn((jcfg.dim,), seed, 0.1)),
                      "bias": jnp.asarray(randn((jcfg.dim,), seed + 1, 0.1))}
    tv = port(jv)
    assert "bias" not in tv["patch_embed"] and "ln_pre" in tv
    init = TV.init_vit(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert {p for p, _ in leaves_with_path(init)} == \
        {p for p, _ in leaves_with_path(tv)}
    imgs = randn((2, 28, 28, 3), 8)
    close(TV.clip_image_embed(tv, port(jh), t(imgs), tcfg),
          JV.clip_image_embed(jv, jh, jnp.asarray(imgs), jcfg))


# ------------------------------------------------------------- stage 1

def stage1_configs():
    jt = dataclasses.replace(
        JST.TINY_TOKENIZER,
        qformer=dataclasses.replace(JST.TINY_TOKENIZER.qformer, with_text=True,
                                    vocab_size=64, max_position=16))
    tt = dataclasses.replace(
        TST.TINY_TOKENIZER,
        qformer=dataclasses.replace(TST.TINY_TOKENIZER.qformer, with_text=True,
                                    vocab_size=64, max_position=16))
    return JTT.Stage1Config(tokenizer=jt), TTT.Stage1Config(tokenizer=tt)


@pytest.fixture(scope="module")
def stage1():
    js1, ts1 = stage1_configs()
    key = jax.random.PRNGKey(0)
    jp = {"tokenizer": JST.init_seed_tokenizer(key, js1.tokenizer),
          "head": JTT.init_stage1_head(jax.random.fold_in(key, 1), js1),
          "itm_head": JTT.init_itm_head(jax.random.fold_in(key, 3), js1),
          "lm_head": JQ.init_lm_head(jax.random.fold_in(key, 4),
                                     js1.tokenizer.qformer)}
    ids, pad = text_batch(4, 9, 64, 11)
    batch = {"images": randn((4, 28, 28, 3), 10), "text_ids": ids,
             "text_pad": pad}
    return js1, ts1, jp, port(jp), batch


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tbatch(batch):
    return {k: t(v) for k, v in batch.items()}


@jax.jit
def jax_stage1_rolled(p, batch, cfg=None):
    """seed_tpu's stage-1 objective with rolled ITM negatives: ITC and LM of
    stage1_total_loss, ITM of _itm_from_feats(sim_feats=None)."""
    cfg = cfg or stage1_configs()[0]
    _, parts = JTT.stage1_total_loss(p, batch, jax.random.PRNGKey(0), cfg)
    feats = JV.vit_apply(p["tokenizer"]["vit"], batch["images"],
                         cfg.tokenizer.vit)
    feats = JST.L.layer_norm(p["tokenizer"]["ln_vision"],
                             jax.lax.stop_gradient(feats))
    itm = JTT._itm_from_feats(p["tokenizer"], p["itm_head"], feats,
                              batch["text_ids"], batch["text_pad"], cfg,
                              jax.random.PRNGKey(0), sim_feats=None)
    return parts["itc"] + itm + parts["lm"], dict(parts, itm=itm)


def rolled(B):
    ar = torch.arange(B)
    return ar.roll(1), ar.roll(-1)


def test_stage1_loss_parts_and_rolled_itm(stage1):
    js1, ts1, jp, tp, batch = stage1
    jtotal, jparts = jax_stage1_rolled(jp, jbatch(batch))
    total, parts = TTT.stage1_total_loss(tp, tbatch(batch), None, ts1,
                                         negatives=rolled(4))
    for k in ("itc", "itm", "lm"):
        close(parts[k], jparts[k], msg=k)
    close(total, jtotal)
    # ITC alone and the port's own rolled variant (sim_feats=None)
    close(TTT.stage1_loss(tp, tbatch(batch), None, ts1),
          jax.jit(lambda p: JTT.stage1_loss(p, jbatch(batch), None, js1))(jp))
    close(TTT.stage1_itm_loss(tp["tokenizer"], tp["itm_head"],
                              t(batch["images"]), t(batch["text_ids"]),
                              t(batch["text_pad"]), ts1),
          jparts["itm"])
    close(TTT.stage1_caption_loss(tp["tokenizer"], tp["lm_head"],
                                  t(batch["images"]), t(batch["text_ids"]),
                                  t(batch["text_pad"]), ts1),
          jparts["lm"])


def test_itm_hard_negative_logits(stage1):
    """The masked logits both sides draw hard negatives from (1e-6), and
    draws from the port's generator that never pick the matching pair."""
    js1, ts1, jp, tp, batch = stage1
    jb, tb = jbatch(batch), tbatch(batch)
    ji, jt_ = JTT.stage1_features(jp["tokenizer"], jp["head"], jb["images"],
                                  jb["text_ids"], jb["text_pad"], js1)
    ti, tt_ = TTT.stage1_features(tp["tokenizer"], tp["head"], tb["images"],
                                  tb["text_ids"], tb["text_pad"], ts1)
    sim = ji @ jt_.T
    masked = jnp.where(jnp.eye(4, dtype=bool), -jnp.inf, sim)
    to_txt, to_img = TTT.itm_negative_logits(ti, tt_)
    for got, want in ((to_txt, masked / 0.07), (to_img, masked.T / 0.07)):
        want = np.asarray(want)
        assert np.array_equal(np.isinf(got.numpy()), np.isinf(want))
        finite = np.isfinite(want)
        np.testing.assert_allclose(got.numpy()[finite], want[finite],
                                   rtol=1e-6, atol=1e-6)
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([TTT._categorical(gen, to_txt) for _ in range(50)])
    assert not (draws == torch.arange(4)).any()
    # the sampled objective is finite and differs from the rolled one only
    # in its ITM term
    total, parts = TTT.stage1_total_loss(tp, tb, gen, ts1)
    assert torch.isfinite(total) and torch.isfinite(parts["itm"])


def test_stage1_gradients_match_jax(stage1):
    """Gradients of every trainable leaf (STAGE1_TRAINABLE) against
    jax.grad, rolled negatives; the frozen ViT takes none."""
    js1, ts1, jp, tp, batch = stage1
    jgrads = jax.jit(jax.grad(lambda p: jax_stage1_rolled(p, jbatch(batch))[0]))(jp)
    want = dict(leaves_with_path(port(jgrads)))
    live = jax.tree.map(lambda x: x.detach(), tp)
    named = [(p, x.requires_grad_()) for p, x in leaves_with_path(live)
             if re.search(TTT.STAGE1_TRAINABLE, p)]
    loss, _ = TTT.stage1_total_loss(live, tbatch(batch), None, ts1,
                                    negatives=rolled(4))
    grads = torch.autograd.grad(loss, [x for _, x in named])
    assert len(named) > 40
    assert not any(p.startswith("tokenizer/vit/") for p, _ in named)
    for (p, _), g in zip(named, grads):
        close(g, want[p], GRAD, msg=p)
    # the frozen ViT: zero gradient in seed_tpu, no graph in the port
    assert all(not v.any() for p, v in want.items()
               if p.startswith("tokenizer/vit/"))


# ------------------------------------------------------------- stage 2

def stage2_configs(use_qformer_image):
    kw = dict(with_recon_blocks=True, use_qformer_image=use_qformer_image)
    return (JTT.Stage2Config(tokenizer=dataclasses.replace(
                JST.TINY_TOKENIZER, **kw)),
            TTT.Stage2Config(tokenizer=dataclasses.replace(
                TST.TINY_TOKENIZER, **kw)))


def stage2_setup(use_qformer_image):
    js2, ts2 = stage2_configs(use_qformer_image)
    jp = JST.init_seed_tokenizer(jax.random.PRNGKey(0), js2.tokenizer)
    # non-zero position embeddings, so the recon and distill paths see them
    for name, seed in (("pos_embed", 20), ("pos_embed_image", 21)):
        jp[name] = jnp.asarray(randn(jp[name].shape, seed, 0.1))
    batch = {"images": randn((3, 28, 28, 3), 12),
             "clip_embeds": randn((3, 16), 13)}
    return js2, ts2, jp, port(jp), batch


@pytest.mark.parametrize("use_qformer_image", [True, False],
                         ids=["reverse_qformer", "image_down"])
def test_stage2_loss_and_gradients(use_qformer_image):
    js2, ts2, jp, tp, batch = stage2_setup(use_qformer_image)
    jl, jm = jax.jit(lambda p: JTT.stage2_loss(p, jbatch(batch), None, js2))(jp)
    live = jax.tree.map(lambda x: x.detach(), tp)
    named = [(p, x.requires_grad_()) for p, x in leaves_with_path(live)
             if re.search(TTT.STAGE2_TRAINABLE, p)]
    loss, metrics = TTT.stage2_loss(live, tbatch(batch), None, ts2)
    close(loss, jl)
    for k in ("vq", "recon", "distill", "codebook_usage"):
        close(metrics[k], jm[k], msg=k)
    assert 0 < float(metrics["codebook_usage"]) <= 1
    jgrads = jax.jit(jax.grad(lambda p: JTT.stage2_loss_scalar(
        p, jbatch(batch), None, js2)))(jp)
    want = dict(leaves_with_path(port(jgrads)))
    grads = torch.autograd.grad(loss, [x for _, x in named],
                                allow_unused=True)
    head = "reverse_qformer" if use_qformer_image else "image_down"
    assert any(p.startswith(head) for p, _ in named)
    for (p, _), g in zip(named, grads):
        close(torch.zeros(want[p].shape) if g is None else g, want[p], GRAD,
              msg=p)


def test_masked_trainable_step_keeps_frozen_leaves():
    """One Trainer step under masked_trainable(adamw) with weight decay:
    frozen leaves (ViT, ln_vision, Q-Former) are the same tensors, bit for
    bit, with no moments; every trained leaf with a gradient moves."""
    _, ts2, _, tp, batch = stage2_setup(True)
    before = {p: x.clone() for p, x in leaves_with_path(tp)}
    opt = TOPT.masked_trainable(
        TOPT.adamw(lambda step: 1e-3, b2=0.999, eps=1e-8, weight_decay=0.05,
                   params=tp), tp, TTT.STAGE2_TRAINABLE)
    tr = Trainer(lambda p, b, r: TTT.stage2_loss(p, b, r, ts2), tp, opt,
                 device="cpu")
    frozen = {p: x for p, x in leaves_with_path(tr.state.params)
              if not re.search(TTT.STAGE2_TRAINABLE, p)}
    metrics = tr.step(tbatch(batch))
    assert set(metrics) == {"loss", "vq", "recon", "distill",
                            "codebook_usage", "grad_norm"}
    after = dict(leaves_with_path(tr.state.params))
    moments = dict(leaves_with_path(tr.state.opt_state["mu"]))
    assert frozen and all(after[p] is x and torch.equal(x, before[p])
                          for p, x in frozen.items())
    assert not set(frozen) & set(moments)
    still = [p for p in moments if torch.equal(after[p], before[p])]
    # the one reverse token's self-attention softmax is over one key: its q
    # and k biases take no gradient
    assert still and all(re.fullmatch(r"reverse_qformer/layers/\d/self/[qk]/bias",
                                      p) for p in still)
