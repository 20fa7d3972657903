"""The SEED tokenizer of seed_tpu_torch against seed_tpu, on the CPU, on
seed_tpu's own weights carried across by seed_tpu_torch.bridge.

Widths are small but the structural triggers of the full model stay: a
224-px image in 14-px patches gives S=257 tokens, dim 176 over 2 heads gives
head dim 88 (not a multiple of 128), and 32 queries. With ``use_flash`` the
ViT attention takes the short-sequence kernel route (its plain version here,
the Pallas kernel in interpret mode on the seed_tpu side).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seed_tpu.models import seed_tokenizer as JST
from seed_tpu.models import vit as JV
from seed_tpu.models.qformer import QFormerConfig as JQFormerConfig
from seed_tpu_torch import bridge
from seed_tpu_torch.models import qformer as TQF
from seed_tpu_torch.models import seed_tokenizer as TST
from seed_tpu_torch.models import vit as TV
from seed_tpu_torch.models.quantizer import nearest_codes

VIT = dict(image_size=224, patch_size=14, dim=176, depth=2, heads=2, mlp_dim=64)
QF = dict(hidden=32, layers=2, heads=2, intermediate=64, encoder_width=176,
          query_len=32)
TOK = dict(codebook_size=64, code_dim=8, decode_depth=2, decode_heads=2,
           image_embed_dim=16)


def from_seed_tpu(tree):
    """seed_tpu weights (numpy leaves) as the port's tensors, on the CPU."""
    return bridge.from_seed_tpu(tree, device="cpu")


def configs(use_flash=True, flash_exact=True, use_qformer_image=False):
    """The same S=257/D=88 tokenizer config on both sides."""
    flags = dict(use_flash=use_flash, flash_exact=flash_exact)
    j = JST.SeedTokenizerConfig(vit=JV.ViTConfig(**VIT, **flags),
                                qformer=JQFormerConfig(**QF), **TOK,
                                use_qformer_image=use_qformer_image)
    t = TST.SeedTokenizerConfig(vit=TV.ViTConfig(**VIT, **flags),
                                qformer=TQF.QFormerConfig(**QF), **TOK,
                                use_qformer_image=use_qformer_image)
    return j, t


def weights(cfg, seed=0):
    jp = JST.init_seed_tokenizer(jax.random.PRNGKey(seed), cfg)
    npp = jax.tree.map(np.asarray, jp)
    return jp, from_seed_tpu(npp)


def images(n, size, seed):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(np.float32)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def s257():
    jcfg, tcfg = configs()
    jp, tp = weights(jcfg)
    return jcfg, tcfg, jp, tp


def test_bridge_layout(s257):
    jcfg, _, jp, tp = s257
    assert isinstance(tp["vit"]["blocks"], list)
    assert len(tp["vit"]["blocks"]) == jcfg.vit.depth
    assert len(tp["blocks_image"]) == jcfg.decode_depth
    assert isinstance(tp["qformer"]["layers"], list)   # already a list
    np.testing.assert_array_equal(
        tp["vit"]["blocks"][1]["attn"]["qkv"]["kernel"].numpy(),
        np.asarray(jp["vit"]["blocks"]["attn"]["qkv"]["kernel"][1]))
    bf = jax.tree.map(np.asarray, {"w": jnp.asarray(np.arange(6.0) / 7,
                                                    jnp.bfloat16)})
    got = from_seed_tpu(bf)["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(bf["w"], np.float32))


def test_seed_causal_mask_matches():
    from seed_tpu.models.qformer import seed_causal_mask
    np.testing.assert_array_equal(TQF.seed_causal_mask(32).numpy(),
                                  np.asarray(seed_causal_mask(32)))


def test_encode_s257_ids_equal_fp32(s257):
    """fp32, exact kernel epilogue: pre-VQ features close, ids EQUAL. The
    seeded inputs' top-2 VQ margin must exceed what the feature error can
    move a distance, so an id flip could not hide as noise."""
    jcfg, tcfg, jp, tp = s257
    x = images(2, 224, 0)
    jz = f32(JST.encode_features(jp, jnp.asarray(x), jcfg))
    tz = f32(TST.encode_features(tp, torch.from_numpy(x), tcfg))
    err = np.abs(tz - jz).max()
    assert err < 1e-4
    cb = np.asarray(jp["vq"]["codebook"], np.float32)
    d = ((jz[..., None, :] - cb) ** 2).sum(-1)            # [B, Q, codes]
    two = np.sort(d, axis=-1)[..., :2]
    margin = (two[..., 1] - two[..., 0]).min()
    radius = np.sqrt(np.sort(d, axis=-1)[..., :2].max())
    D = cb.shape[1]
    # |d_j(z+e) - d_j(z)| <= 2 |z - c_j| |e| + |e|^2, |e| <= sqrt(D) err
    moved = 2 * (2 * radius * np.sqrt(D) * err + D * err ** 2)
    assert margin > moved, (margin, moved)
    want = np.asarray(JST.encode(jp, jnp.asarray(x), jcfg))
    got = TST.encode(tp, torch.from_numpy(x), tcfg)
    assert got.dtype == torch.int32 and got.shape == (2, 32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_encode_s257_serving_fast_features_close(s257):
    """serving_fast_config: the kernel's fast epilogue (D=88 -> ones-column
    row sum) and tanh GELU, same config transform on both sides."""
    jcfg, tcfg, jp, tp = s257
    jfast, tfast = JST.serving_fast_config(jcfg), TST.serving_fast_config(tcfg)
    assert tfast.vit.use_flash and tfast.vit.act == "gelu_tanh"
    x = images(2, 224, 1)
    jz = f32(JST.encode_features(jp, jnp.asarray(x), jfast))
    tz = f32(TST.encode_features(tp, torch.from_numpy(x), tfast))
    np.testing.assert_allclose(tz, jz, atol=1e-4)


@pytest.mark.parametrize("use_flash", [False, True])
def test_tiny_tokenizer_encode_equal(use_flash):
    """TINY_TOKENIZER (S=5: below the kernel's minimum, so mha either way)."""
    jcfg = dataclasses.replace(JST.TINY_TOKENIZER, vit=dataclasses.replace(
        JST.TINY_TOKENIZER.vit, use_flash=use_flash))
    tcfg = dataclasses.replace(TST.TINY_TOKENIZER, vit=dataclasses.replace(
        TST.TINY_TOKENIZER.vit, use_flash=use_flash))
    jp, tp = weights(jcfg, seed=3)
    x = images(3, 28, 2)
    np.testing.assert_allclose(
        f32(TST.encode_features(tp, torch.from_numpy(x), tcfg)),
        f32(JST.encode_features(jp, jnp.asarray(x), jcfg)), atol=1e-5)
    np.testing.assert_array_equal(
        TST.encode(tp, torch.from_numpy(x), tcfg).numpy(),
        np.asarray(JST.encode(jp, jnp.asarray(x), jcfg)))


@pytest.mark.parametrize("use_qformer_image", [False, True])
def test_decode_embedding_close(use_qformer_image):
    """Both distill heads: image_down MLP and the 1-token Reverse Q-Former.
    Out-of-range ids clip to the codebook on both sides."""
    jcfg, tcfg = configs(use_qformer_image=use_qformer_image)
    jp, tp = weights(jcfg, seed=4)
    ids = np.random.RandomState(5).randint(0, 64, (2, 32))
    ids[0, 0], ids[1, 5] = -3, 999
    want = f32(JST.decode_embedding(jp, jnp.asarray(ids), jcfg))
    got = f32(TST.decode_embedding(tp, torch.from_numpy(ids), tcfg))
    assert got.shape == (2, 16)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_nearest_codes_ties_go_to_lowest_index():
    cb = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0]])
    z = torch.tensor([[[1.0, 0.0], [0.5, 0.5]]])
    assert nearest_codes(cb, z).tolist() == [[0, 0]]


def test_init_defaults_to_the_card():
    """Entry points run on the card unless the caller asks for the CPU; a
    machine with no CUDA gets a clear error, never a silent CPU run."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the default device is valid")
    gen = torch.Generator()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TST.init_seed_tokenizer(gen, TST.TINY_TOKENIZER)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bridge.from_seed_tpu({"w": np.zeros(2, np.float32)})
    p = TST.init_seed_tokenizer(gen.manual_seed(0), TST.TINY_TOKENIZER,
                                device="cpu")
    ids = TST.encode(p, torch.zeros(1, 28, 28, 3), TST.TINY_TOKENIZER)
    assert ids.shape == (1, 8)
