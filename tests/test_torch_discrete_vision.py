"""The discrete vision model and the quantizer's training variants of
seed_tpu_torch against seed_tpu, on the CPU in fp32, on seed_tpu's own
weights carried across by seed_tpu_torch.bridge: both DVM variants (both
encoders, both quantizers), the gumbel, EMA, norm-EMA and k-means codebook
code, and the training crop.

Contracts: code ids equal; losses within 1e-5 relative; gradients of the
trainable leaves within 1e-4 relative of jax.grad; the frozen tower and the
tied head get no gradient; the EMA updates and the k-means init within
1e-6. Torch cannot reproduce jax.random (the Sampling contract): where
seed_tpu draws (the gumbel noise, the k-means seeds, the crop's area,
offsets and flips) the test hands seed_tpu's draws to the port, and never
compares draws.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seed_tpu.models import discrete_vision as JDV
from seed_tpu.models import quantizer as JQ
from seed_tpu.models import vit as JV
from seed_tpu_torch import bridge
from seed_tpu_torch.models import discrete_vision as TDV
from seed_tpu_torch.models import quantizer as TQ
from seed_tpu_torch.models import vit as TV
from seed_tpu_torch.ops.preprocess import random_resized_crop_flip
from seed_tpu_torch.utils.tree import leaves_with_path

JP = importlib.import_module("seed_tpu.ops.preprocess")

LOSS = dict(rtol=1e-5, atol=1e-6)
FWD = dict(rtol=1e-5, atol=1e-5)       # activations (sums in another order)
GRAD = dict(rtol=1e-4, atol=1e-6)
EMA = dict(rtol=1e-6, atol=1e-6)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=msg,
                               **tol)


def grads_of(loss, tree):
    """{path: gradient or None} of every leaf of ``tree`` (which requires
    grad)."""
    named = leaves_with_path(tree)
    got = torch.autograd.grad(loss, [x for _, x in named], allow_unused=True)
    return dict(zip((p for p, _ in named), got))


def requires_grad(tree):
    from seed_tpu_torch.utils.tree import tree_map
    return tree_map(lambda x: x.detach().clone().requires_grad_(), tree)


def assert_grads_match(got: dict, jgrads_port, prefix=""):
    want = dict(leaves_with_path(jgrads_port))
    assert set(want) == set(got)
    for path, g in got.items():
        assert g is not None, f"{prefix}{path} got no gradient"
        w = want[path].numpy()
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD["rtol"],
                                   atol=GRAD["rtol"] * scale,
                                   err_msg=prefix + path)


# ------------------------------------------------------------------- DVM

TOWER = dict(image_size=28, patch_size=14, dim=JDV.TINY_DVM.hidden, depth=2,
             heads=2, mlp_dim=64, qkv_bias="full", act="quick_gelu",
             ln_eps=1e-5, ln_pre=True, patch_bias=False)


@pytest.fixture(scope="module")
def dvm():
    cfg = JDV.TINY_DVM
    jtower_cfg = JV.ViTConfig(**TOWER)
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(0), 4)
    params = jax.jit(JDV.init_dvm, static_argnums=1)(k1, cfg)
    # non-zero biases, so every leaf's gradient is exercised
    params = jax.tree.map(
        lambda x: x + 0.02 * jax.random.normal(k4, x.shape)
        if x.ndim and x.shape[-1] != cfg.code_dim else x, params)
    tower = jax.jit(JV.init_vit, static_argnums=1)(k2, jtower_cfg)
    head = JV.init_clip_vision_projection(k3, jtower_cfg,
                                          proj_dim=cfg.proj_dim)
    images = np.random.RandomState(1).randn(3, 28, 28, 3).astype(np.float32)
    return cfg, jtower_cfg, params, tower, head, images


def test_dvm_tree_carries_across(dvm):
    cfg, _, params, *_ = dvm
    ported = bridge.dvm_from_seed_tpu(np_tree(params), device="cpu")
    fresh = TDV.init_dvm(torch.Generator().manual_seed(0), TDV.TINY_DVM,
                         device="cpu")
    shapes = lambda tree: {p: tuple(x.shape) for p, x in leaves_with_path(tree)}
    assert shapes(ported) == shapes(fresh)
    assert len(ported["quant_encoder"]) == cfg.depth


def test_dvm_loss_ids_and_gradients_match_jax(dvm):
    cfg, jtcfg, params, tower, head, images = dvm
    tcfg = TV.ViTConfig(**TOWER)

    def jloss(p, tw, hd):
        return JDV.dvm_loss(p, tw, hd, jnp.asarray(images), cfg, jtcfg)

    (jtotal, jm), (jgp, jgt, jgh) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(params, tower, head)

    p = requires_grad(bridge.dvm_from_seed_tpu(np_tree(params), "cpu"))
    tw = requires_grad(bridge.from_seed_tpu(np_tree(tower), "cpu"))
    hd = requires_grad(bridge.from_seed_tpu(np_tree(head), "cpu"))
    total, m = TDV.dvm_loss(p, tw, hd, t(images), TDV.TINY_DVM, tcfg)
    np.testing.assert_array_equal(m["indices"].numpy(),
                                  np.asarray(jm["indices"]))
    for k in ("loss_rec", "loss_quant", "loss_iti"):
        close(m[k], jm[k], LOSS, k)
    close(total, jtotal, LOSS)

    got = grads_of(total, {"dvm": p, "tower": tw, "head": hd})
    # the frozen tower and the tied head get no gradient (jax: zeros)
    for path, g in got.items():
        if not path.startswith("dvm/"):
            assert g is None, path
    assert all(float(np.abs(x).max()) == 0.0
               for x in jax.tree.leaves((jgt, jgh)))
    assert_grads_match({k[4:]: g for k, g in got.items()
                        if k.startswith("dvm/")},
                       bridge.dvm_from_seed_tpu(np_tree(jgp), "cpu"), "dvm/")


def test_dvm_tied_head_passes_gradient_to_predict_state(dvm):
    """The contrastive loss alone reaches the quant decoder through the
    frozen head (detaching the head's output instead would cut it)."""
    cfg, _, params, tower, head, images = dvm
    p = requires_grad(bridge.dvm_from_seed_tpu(np_tree(params), "cpu"))
    _, m = TDV.dvm_loss(p, bridge.from_seed_tpu(np_tree(tower), "cpu"),
                        bridge.from_seed_tpu(np_tree(head), "cpu"), t(images),
                        TDV.TINY_DVM, TV.ViTConfig(**TOWER))
    g = torch.autograd.grad(m["loss_iti"],
                            p["quant_decoder"][-1]["mlp"]["fc2"]["bias"])[0]
    assert float(g.abs().max()) > 0


def test_dvm_encode_decode_match_jax(dvm):
    cfg, jtcfg, params, tower, *_ = dvm
    hidden = JV.vit_apply(tower, jnp.asarray(dvm[5]), jtcfg)
    jids = JDV.dvm_encode(params, hidden, cfg)
    p = bridge.dvm_from_seed_tpu(np_tree(params), "cpu")
    ids = TDV.dvm_encode(p, t(hidden), TDV.TINY_DVM)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    close(TDV.dvm_decode(p, ids, TDV.TINY_DVM),
          JDV.dvm_decode(params, jids, cfg), FWD)


def test_contrastive_loss_and_axis_name():
    rs = np.random.RandomState(4)
    x, y = rs.randn(6, 8).astype(np.float32), rs.randn(6, 8).astype(np.float32)
    want = JDV.clip_contrastive_loss(jnp.asarray(2.6592), jnp.asarray(x),
                                     jnp.asarray(y))
    close(TDV.clip_contrastive_loss(torch.tensor(2.6592), t(x), t(y)), want,
          LOSS)
    # an axis name resolves against a mesh (the gather itself is held
    # against seed_tpu in tests/test_torch_parallel.py)
    with pytest.raises(RuntimeError, match="make_mesh"):
        TDV.clip_contrastive_loss(torch.tensor(2.6592), t(x), t(y),
                                  axis_name="data")


@pytest.mark.parametrize("encoder", ["simple", "transformer"])
@pytest.mark.parametrize("quantizer", ["st", "norm_ema"])
def test_clip_embed_dvm_matches_jax(encoder, quantizer):
    kw = dict(embed_dim=64, num_token=4, code_dim=8, n_codes=32,
              encoder=encoder, quantizer=quantizer, hidden=32, depth=1,
              heads=2, mlp_dim=64, act="gelu" if encoder == "simple" else "no")
    jcfg, tcfg = JDV.ClipEmbedDVMConfig(**kw), TDV.ClipEmbedDVMConfig(**kw)
    params = JDV.init_clip_embed_dvm(jax.random.PRNGKey(0), jcfg)
    embed = np.random.RandomState(1).randn(5, 64).astype(np.float32)
    (jtotal, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JDV.dvm_clip_embed_loss(p, jnp.asarray(embed), jcfg),
        has_aux=True))(params)

    p = requires_grad(bridge.from_seed_tpu(np_tree(params), "cpu"))
    fresh = TDV.init_clip_embed_dvm(torch.Generator().manual_seed(0), tcfg,
                                    device="cpu")
    assert ({k: tuple(x.shape) for k, x in leaves_with_path(p)}
            == {k: tuple(x.shape) for k, x in leaves_with_path(fresh)})
    total, m = TDV.dvm_clip_embed_loss(p, t(embed), tcfg)
    np.testing.assert_array_equal(m["indices"].numpy(),
                                  np.asarray(jm["indices"]))
    for k in ("loss_rec", "loss_quant"):
        close(m[k], jm[k], LOSS, k)
    for k in ("predict_embed", "z"):
        close(m[k], jm[k], FWD, k)
    close(total, jtotal, LOSS)
    got = grads_of(total, p)
    want = bridge.from_seed_tpu(np_tree(jg), "cpu")
    if quantizer == "norm_ema":
        # the codebook learns by EMA: no gradient (jax: zeros)
        for k in ("vq/codebook", "vq/cluster_size", "vq/embed_avg"):
            assert got.pop(k) is None
        assert all(float(np.abs(x).max()) == 0.0
                   for x in jax.tree.leaves(jg["vq"]))
        want = {k: v for k, v in want.items() if k != "vq"}
    assert_grads_match(got, want)


# ------------------------------------------------------ quantizer variants

@pytest.fixture(scope="module")
def gumbel():
    params = JQ.init_gumbel(jax.random.PRNGKey(0), 16, 8, 12)
    z = np.random.RandomState(2).randn(3, 5, 12).astype(np.float32)
    return params, z


def test_init_gumbel_shapes():
    p = TQ.init_gumbel(torch.Generator().manual_seed(0), 16, 8, 12,
                       device="cpu")
    j = JQ.init_gumbel(jax.random.PRNGKey(0), 16, 8, 12)
    assert ({k: tuple(x.shape) for k, x in leaves_with_path(p)}
            == {k: tuple(np.shape(x)) for k, x in
                leaves_with_path(bridge.from_seed_tpu(np_tree(j), "cpu"))})
    assert float(p["proj"]["kernel"].abs().max()) <= 2 * 12 ** -0.5


@pytest.mark.parametrize("hard", [True, False])
def test_gumbel_quantize_deterministic(gumbel, hard):
    params, z = gumbel
    want = JQ.gumbel_quantize(params, jnp.asarray(z), None, temp=0.7,
                              hard=hard)
    got = TQ.gumbel_quantize(bridge.from_seed_tpu(np_tree(params), "cpu"),
                             t(z), None, temp=0.7, hard=hard)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    close(got.quantized, want.quantized, FWD)
    close(got.loss, want.loss, LOSS)


def test_gumbel_quantize_with_seed_tpu_draws(gumbel):
    params, z = gumbel
    rng = jax.random.PRNGKey(7)
    want = JQ.gumbel_quantize(params, jnp.asarray(z), rng)
    u = jax.random.uniform(rng, (3, 5, 16), minval=1e-10, maxval=1.0)
    p = bridge.from_seed_tpu(np_tree(params), "cpu")
    got = TQ.gumbel_quantize(p, t(z), uniform=t(u))
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    close(got.quantized, want.quantized, FWD)
    close(got.loss, want.loss, LOSS)
    # drawn from a torch.Generator: valid ids, the same regularizer
    drawn = TQ.gumbel_quantize(p, t(z), torch.Generator().manual_seed(0))
    assert drawn.indices.shape == (3, 5) and int(drawn.indices.max()) < 16
    close(drawn.loss, want.loss, LOSS)


def test_ema_update_matches_jax():
    params = JQ.init_ema_codebook(jax.random.PRNGKey(0), 16, 8)
    rs = np.random.RandomState(3)
    z = rs.randn(4, 6, 8).astype(np.float32)
    idx = rs.randint(0, 16, (4, 6)).astype(np.int32)
    p = bridge.from_seed_tpu(np_tree(params), "cpu")
    want, got = params, p
    for _ in range(2):       # the second step starts from non-zero clusters
        want = JQ.ema_update(want, jnp.asarray(z), jnp.asarray(idx))
        got = TQ.ema_update(got, t(z), t(idx))
    for k in ("codebook", "cluster_size", "embed_avg"):
        close(got[k], want[k], EMA, k)
    fresh = TQ.init_ema_codebook(torch.Generator().manual_seed(0), 16, 8,
                                 device="cpu")
    close(fresh["codebook"].norm(dim=-1), np.ones(16), EMA)
    assert torch.equal(fresh["codebook"], fresh["embed_avg"])


def test_norm_ema_quantize_and_update_match_jax():
    params = JQ.init_ema_codebook(jax.random.PRNGKey(0), 16, 8)
    z = np.random.RandomState(4).randn(4, 6, 8).astype(np.float32)
    p = bridge.from_seed_tpu(np_tree(params), "cpu")
    want = JQ.norm_ema_quantize(params, jnp.asarray(z))
    zt = t(z).requires_grad_()
    got = TQ.norm_ema_quantize(p, zt)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    close(got.quantized, want.quantized, EMA)
    close(got.loss, want.loss, LOSS)
    jgz = jax.grad(lambda zz: JQ.norm_ema_quantize(params, zz).loss)(
        jnp.asarray(z))
    close(torch.autograd.grad(got.loss, zt)[0], jgz, GRAD)
    # 16 codes, 24 rows: some codes get no row and keep theirs
    jn, tn = params, p
    for _ in range(2):
        jn = JQ.norm_ema_update(jn, jnp.asarray(z), want.indices, decay=0.9)
        tn = TQ.norm_ema_update(tn, t(z), got.indices, decay=0.9)
    for k in ("codebook", "cluster_size", "embed_avg"):
        close(tn[k], jn[k], EMA, k)
    with pytest.raises(RuntimeError, match="make_mesh"):
        TQ.norm_ema_update(p, t(z), got.indices, axis_name="data")


@pytest.mark.parametrize("n,n_codes", [(80, 6), (5, 8)])
def test_kmeans_init_codebook_with_seed_tpu_draws(n, n_codes):
    rs = np.random.RandomState(5)
    samples = rs.randn(n, 8).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = JQ.kmeans_init_codebook(key, jnp.asarray(samples), n_codes)
    seeds = (jax.random.permutation(key, n)[:n_codes] if n >= n_codes
             else jax.random.randint(key, (n_codes,), 0, n))
    got = TQ.kmeans_init_codebook(None, t(samples), n_codes,
                                  seeds=t(np.asarray(seeds)))
    close(got, want, EMA)
    drawn = TQ.kmeans_init_codebook(torch.Generator().manual_seed(0),
                                    t(samples), n_codes)
    assert drawn.shape == (n_codes, 8)
    close(drawn.norm(dim=-1), np.ones(n_codes), dict(rtol=0, atol=1e-5))


# ------------------------------------------------------------ the crop

@pytest.mark.parametrize("image_size,scale", [(16, (0.5, 0.5)),
                                              (64, (0.3, 1.0))],
                         ids=["downscale", "upscale"])
def test_random_resized_crop_flip_with_seed_tpu_draws(image_size, scale):
    imgs = np.random.RandomState(6).rand(6, 40, 40, 3).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = JP.random_resized_crop_flip(key, jnp.asarray(imgs), image_size,
                                       scale)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    B = imgs.shape[0]
    draws = (jax.random.uniform(k1, (B,), minval=scale[0], maxval=scale[1]),
             jax.random.uniform(k2, (B,)), jax.random.uniform(k3, (B,)),
             jax.random.bernoulli(k4, 0.5, (B,)))
    flips = np.asarray(draws[3])
    assert flips.any() and not flips.all()
    got = random_resized_crop_flip(t(imgs), image_size, scale,
                                   draws=[t(np.asarray(d)) for d in draws])
    assert got.shape == (B, image_size, image_size, 3)
    close(got, want, dict(rtol=0, atol=1e-5))
    drawn = random_resized_crop_flip(t(imgs), image_size, scale,
                                     gen=torch.Generator().manual_seed(0))
    assert drawn.shape == got.shape and drawn.isfinite().all()
