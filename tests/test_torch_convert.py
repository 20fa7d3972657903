"""The checkpoint converters of seed_tpu_torch against seed_tpu's, on the CPU.

Synthetic state dicts carry the reference's key names and shapes at a tiny
size. The port's converter must give, leaf for leaf and bit for bit, what
seed_tpu's converter gives after the bridge (``bridge.from_seed_tpu``, and
``bridge.convs_to_oihw`` for conv kernels). The command line
``python3 -m seed_tpu_torch.convert`` is run once as a subprocess and its
other families in-process, each read back with ``restore_checkpoint``.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from seed_tpu.convert import torch_convert as JC
from seed_tpu.convert import unclip_convert as JUC
from seed_tpu.models import seed_tokenizer as JST
from seed_tpu.models import unclip as JU
from seed_tpu_torch import bridge
from seed_tpu_torch.convert import __main__ as CLI
from seed_tpu_torch.convert import torch_convert as TC
from seed_tpu_torch.convert import unclip_convert as TUC
from seed_tpu_torch.models import seed_tokenizer as TST
from seed_tpu_torch.models import unclip as TU
from seed_tpu_torch.utils.checkpoint import restore_checkpoint
from seed_tpu_torch.utils.tree import leaves_with_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_same_tree(got, want):
    """Same structure (dicts, lists) and every leaf equal bit for bit, with
    its dtype; 4-D conv kernels stored channels_last. Key order is not
    compared (jax.tree.map sorts dict keys)."""
    g, w = sorted(leaves_with_path(got)), sorted(leaves_with_path(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path
        if a.dim() == 4:
            assert a.is_contiguous(memory_format=torch.channels_last), path
    assert _kinds(got) == _kinds(want)


def _kinds(tree):
    if isinstance(tree, dict):
        return {k: _kinds(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_kinds(v) for v in tree]
    return None


def via_bridge(tree, convs=False):
    """seed_tpu's converter output as the port would receive it."""
    out = bridge.from_seed_tpu(jax.tree.map(np.asarray, tree), device="cpu")
    return bridge.convs_to_oihw(out) if convs else out


class Rand:
    def __init__(self, seed):
        self.rs = np.random.RandomState(seed)

    def __call__(self, *shape):
        return self.rs.standard_normal(shape).astype(np.float32)


# ------------------------------ quantizer -----------------------------------

def vit_block(sd, r, p, D, mlp, qv_bias):
    for n in ("norm1", "norm2"):
        sd[f"{p}.{n}.weight"], sd[f"{p}.{n}.bias"] = r(D), r(D)
    sd[f"{p}.attn.qkv.weight"] = r(3 * D, D)
    if qv_bias:
        sd[f"{p}.attn.q_bias"], sd[f"{p}.attn.v_bias"] = r(D), r(D)
    else:
        sd[f"{p}.attn.qkv.bias"] = r(3 * D)
    sd[f"{p}.attn.proj.weight"], sd[f"{p}.attn.proj.bias"] = r(D, D), r(D)
    sd[f"{p}.mlp.fc1.weight"], sd[f"{p}.mlp.fc1.bias"] = r(mlp, D), r(mlp)
    sd[f"{p}.mlp.fc2.weight"], sd[f"{p}.mlp.fc2.bias"] = r(D, mlp), r(D)


def linear(sd, r, p, n_out, n_in, bias=True):
    sd[f"{p}.weight"] = r(n_out, n_in)
    if bias:
        sd[f"{p}.bias"] = r(n_out)


def norm(sd, r, p, n):
    sd[f"{p}.weight"], sd[f"{p}.bias"] = r(n), r(n)


def qformer(sd, r, prefix, q, enc, with_text):
    H = q.hidden
    norm(sd, r, f"{prefix}.bert.embeddings.LayerNorm", H)
    for i in range(q.layers):
        p = f"{prefix}.bert.encoder.layer.{i}"
        blocks = ["attention"] + (["crossattention"] if i % q.cross_freq == 0
                                  else [])
        for a in blocks:
            kv_in = enc if a == "crossattention" else H
            linear(sd, r, f"{p}.{a}.self.query", H, H)
            linear(sd, r, f"{p}.{a}.self.key", H, kv_in)
            linear(sd, r, f"{p}.{a}.self.value", H, kv_in)
            linear(sd, r, f"{p}.{a}.output.dense", H, H)
            norm(sd, r, f"{p}.{a}.output.LayerNorm", H)
        for suffix in ("_query",) + (("",) if with_text else ()):
            linear(sd, r, f"{p}.intermediate{suffix}.dense", q.intermediate, H)
            linear(sd, r, f"{p}.output{suffix}.dense", H, q.intermediate)
            norm(sd, r, f"{p}.output{suffix}.LayerNorm", H)


def quantizer_sd(variant, seed=0):
    """Blip2QformerQuantizer keys at TINY_TOKENIZER's sizes. ``variant``:
    the released image_down head, the Reverse Q-Former head, or the stage-2
    artifacts (recon blocks and the Q-Former's text path)."""
    cfg, r, sd = JST.TINY_TOKENIZER, Rand(seed), {}
    v, q = cfg.vit, cfg.qformer
    D, H = v.dim, q.hidden
    sd["visual_encoder.patch_embed.proj.weight"] = r(D, 3, v.patch_size, v.patch_size)
    sd["visual_encoder.patch_embed.proj.bias"] = r(D)
    sd["visual_encoder.cls_token"] = r(1, 1, D)
    sd["visual_encoder.pos_embed"] = r(1, v.num_patches + 1, D)
    for i in range(v.depth):
        vit_block(sd, r, f"visual_encoder.blocks.{i}", D, v.mlp_dim, True)
    norm(sd, r, "ln_vision", D)
    sd["query_tokens"] = r(1, q.query_len, H)
    qformer(sd, r, "Qformer", q, q.encoder_width, variant == "stage2")
    linear(sd, r, "encode_task_layer.0", H, H)
    linear(sd, r, "encode_task_layer.2", cfg.code_dim, H)
    sd["quantize.embedding.weight"] = r(cfg.codebook_size, cfg.code_dim)
    linear(sd, r, "decode_task_layer.0", cfg.code_dim, cfg.code_dim)
    linear(sd, r, "decode_task_layer.2", H, cfg.code_dim)
    sd["pos_embed_image"] = r(1, q.query_len, H)
    for i in range(cfg.decode_depth):
        vit_block(sd, r, f"blocks_image.{i}", H, 4 * H, False)
    if variant == "reverse":
        sd["reverse_tokens"] = r(1, 1, H)
        rq = cfg.reverse_qformer
        qformer(sd, r, "Reverse_Qformer", rq, rq.encoder_width, False)
        linear(sd, r, "distill_image_proj", cfg.image_embed_dim, H)
    else:
        linear(sd, r, "image_down.0", 256, H, bias=False)
        linear(sd, r, "image_down.2", 128, 256, bias=False)
        linear(sd, r, "image_down.4", 32, 128, bias=False)
        linear(sd, r, "distill_image_proj", cfg.image_embed_dim,
               q.query_len * 32)
    if variant == "stage2":
        sd["pos_embed"] = r(1, q.query_len, H)
        for i in range(2):
            vit_block(sd, r, f"blocks.{i}", H, 4 * H, False)
    return sd


@pytest.mark.parametrize("variant", ["released", "reverse", "stage2"])
def test_quantizer_equals_seed_tpu(variant):
    sd = quantizer_sd(variant)
    with_text = variant == "stage2"
    got = TC.convert_quantizer(sd, with_text=with_text, device="cpu")
    assert_same_tree(got, via_bridge(JC.convert_quantizer(sd, with_text)))
    if with_text:
        assert "ffn_t" in got["qformer"]["layers"][0]


def test_quantizer_tree_is_the_ports_and_encodes():
    """The released layout is the tree of the port's own init, and runs."""
    got = TC.convert_quantizer(quantizer_sd("released"), device="cpu")
    ref = TST.init_seed_tokenizer(torch.Generator().manual_seed(0),
                                  TST.TINY_TOKENIZER, device="cpu")
    assert (sorted((p, tuple(t.shape)) for p, t in leaves_with_path(got))
            == sorted((p, tuple(t.shape)) for p, t in leaves_with_path(ref)))
    ids = TST.encode(got, torch.zeros(2, 28, 28, 3), TST.TINY_TOKENIZER)
    assert ids.shape == (2, 8)


# -------------------------------- llama -------------------------------------

def llama_sd(seed=1, vocab=270, dim=64, ffn=128, layers=2, kv=32):
    r, sd = Rand(seed), {}
    sd["model.embed_tokens.weight"] = r(vocab, dim)
    sd["lm_head.weight"] = r(vocab, dim)
    sd["model.norm.weight"] = r(dim)
    for i in range(layers):
        p = f"model.layers.{i}"
        sd[f"{p}.input_layernorm.weight"] = r(dim)
        sd[f"{p}.post_attention_layernorm.weight"] = r(dim)
        for n, shape in (("q_proj", (dim, dim)), ("k_proj", (kv, dim)),
                         ("v_proj", (kv, dim)), ("o_proj", (dim, dim))):
            sd[f"{p}.self_attn.{n}.weight"] = r(*shape)
        for n, shape in (("gate_proj", (ffn, dim)), ("up_proj", (ffn, dim)),
                         ("down_proj", (dim, ffn))):
            sd[f"{p}.mlp.{n}.weight"] = r(*shape)
    return sd


@pytest.mark.parametrize("padded", [None, 384])
def test_llama_equals_seed_tpu(padded):
    sd = llama_sd()
    got = TC.convert_llama(sd, padded, device="cpu")
    assert_same_tree(got, via_bridge(JC.convert_llama(sd, padded)))
    assert isinstance(got["layers"], list) and len(got["layers"]) == 2
    assert got["embed_tokens"]["embedding"].shape[0] == (padded or 270)


# --------------------------------- lora -------------------------------------

def lora_sd(seed=2, layers=3, dim=16, ffn=24, rank=4):
    r, sd = Rand(seed), {}
    shapes = {"q_proj": (dim, dim), "v_proj": (dim, dim),
              "down_proj": (dim, ffn)}
    for i in range(layers):
        for proj, (n_out, n_in) in shapes.items():
            kind = "mlp" if proj == "down_proj" else "self_attn"
            p = f"base_model.model.model.layers.{i}.{kind}.{proj}"
            sd[f"{p}.lora_A.weight"] = r(rank, n_in)
            sd[f"{p}.lora_B.weight"] = r(n_out, rank)
    sd["base_model.model.lm_head.weight"] = r(8, dim)    # not an adapter
    return sd


@pytest.mark.parametrize("alpha,r", [(32.0, None), (16.0, 8.0)])
def test_lora_equals_seed_tpu(alpha, r):
    sd = lora_sd()
    got = TC.convert_lora(sd, alpha, r, device="cpu")
    want = bridge.lora_from_seed_tpu(
        jax.tree.map(np.asarray, JC.convert_lora(sd, alpha, r)), device="cpu")
    assert sorted(got["adapters"]) == sorted(want["adapters"])
    assert_same_tree(got, want)
    assert "layers/2/down_proj/kernel" in got["adapters"]


# ------------------------------- inception ----------------------------------

def inception_sd(seed=3, with_fc=True):
    r, sd = Rand(seed), {}
    for name, (cin, cout, k, _, _) in TC.INCEPTION_CONVS.items():
        sd[f"{name}.conv.weight"] = r(cout, cin, *k)
        sd[f"{name}.bn.weight"] = r(cout)
        sd[f"{name}.bn.bias"] = r(cout)
        sd[f"{name}.bn.running_mean"] = r(cout)
        sd[f"{name}.bn.running_var"] = np.abs(r(cout)) + 0.1
    if with_fc:
        sd["fc.weight"], sd["fc.bias"] = r(1000, 2048), r(1000)
    sd["AuxLogits.fc.weight"] = r(4, 4)    # ignored
    return sd


def test_inception_table_equals_seed_tpu():
    from seed_tpu.eval.inception import BN_EPS, INCEPTION_CONVS
    assert TC.INCEPTION_CONVS == INCEPTION_CONVS and TC.BN_EPS == BN_EPS


@pytest.mark.parametrize("with_fc", [True, False])
def test_inception_equals_seed_tpu(with_fc):
    """BatchNorm folded in float64 on both sides; conv kernels OIHW."""
    sd = inception_sd(with_fc=with_fc)
    got = TC.convert_inception_torch(sd, device="cpu")
    assert_same_tree(got, via_bridge(JC.convert_inception_torch(sd), convs=True))
    assert ("fc" in got) == with_fc


def test_inception_rejects_a_wrong_shape():
    sd = {"Conv2d_1a_3x3.conv.weight": np.zeros((32, 3, 5, 5), np.float32)}
    with pytest.raises(ValueError, match="Conv2d_1a_3x3"):
        TC.convert_inception_torch(sd, device="cpu")


# -------------------------------- unclip ------------------------------------

def _seeded_tree(init, cfg, seed):
    shapes = jax.eval_shape(lambda k: init(k, cfg), jax.random.PRNGKey(0))
    r = Rand(seed)
    return jax.tree.map(lambda s: 0.3 * r(*s.shape), shapes)


def inv_linear(sd, prefix, p):
    sd[f"{prefix}.weight"] = np.ascontiguousarray(p["kernel"].T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = p["bias"]


def inv_conv(sd, prefix, p):
    sd[f"{prefix}.weight"] = np.ascontiguousarray(p["kernel"].transpose(3, 2, 0, 1))
    sd[f"{prefix}.bias"] = p["bias"]


def inv_norm(sd, prefix, p):
    sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = p["scale"], p["bias"]


def inv_resnet(sd, prefix, p):
    for n in ("norm1", "norm2"):
        inv_norm(sd, f"{prefix}.{n}", p[n])
    for n in ("conv1", "conv2", "conv_shortcut"):
        if n in p:
            inv_conv(sd, f"{prefix}.{n}", p[n])
    if "time_emb_proj" in p:
        inv_linear(sd, f"{prefix}.time_emb_proj", p["time_emb_proj"])


def inv_attn(sd, prefix, p):
    for n in ("to_q", "to_k", "to_v"):
        inv_linear(sd, f"{prefix}.{n}", p[n])
    inv_linear(sd, f"{prefix}.to_out.0", p["to_out"])


def inv_spatial(sd, prefix, p):
    inv_norm(sd, f"{prefix}.norm", p["norm"])
    inv_linear(sd, f"{prefix}.proj_in", p["proj_in"])
    inv_linear(sd, f"{prefix}.proj_out", p["proj_out"])
    for i, blk in enumerate(p["blocks"]):
        b = f"{prefix}.transformer_blocks.{i}"
        for n in ("norm1", "norm2", "norm3"):
            inv_norm(sd, f"{b}.{n}", blk[n])
        inv_attn(sd, f"{b}.attn1", blk["attn1"])
        inv_attn(sd, f"{b}.attn2", blk["attn2"])
        inv_linear(sd, f"{b}.ff.net.0.proj", blk["ff"]["proj"])
        inv_linear(sd, f"{b}.ff.net.2", blk["ff"]["out"])


def unet_sd(tree):
    sd = {}
    inv_conv(sd, "conv_in", tree["conv_in"])
    inv_conv(sd, "conv_out", tree["conv_out"])
    inv_norm(sd, "conv_norm_out", tree["conv_norm_out"])
    for e in ("time_embedding", "class_embedding"):
        for n in ("linear_1", "linear_2"):
            inv_linear(sd, f"{e}.{n}", tree[e][n])
    for kind, sampler in (("down", "downsample"), ("up", "upsample")):
        for i, blk in enumerate(tree[f"{kind}_blocks"]):
            for j, r in enumerate(blk["resnets"]):
                inv_resnet(sd, f"{kind}_blocks.{i}.resnets.{j}", r)
            for j, a in enumerate(blk["attentions"]):
                inv_spatial(sd, f"{kind}_blocks.{i}.attentions.{j}", a)
            if sampler in blk:
                inv_conv(sd, f"{kind}_blocks.{i}.{sampler}rs.0.conv", blk[sampler])
    for j, r in enumerate(tree["mid_block"]["resnets"]):
        inv_resnet(sd, f"mid_block.resnets.{j}", r)
    inv_spatial(sd, "mid_block.attentions.0", tree["mid_block"]["attentions"][0])
    return sd


def vae_sd(tree):
    sd = {}
    inv_conv(sd, "post_quant_conv", tree["post_quant_conv"])
    inv_conv(sd, "decoder.conv_in", tree["conv_in"])
    inv_conv(sd, "decoder.conv_out", tree["conv_out"])
    inv_norm(sd, "decoder.conv_norm_out", tree["conv_norm_out"])
    for j, r in enumerate(tree["mid"]["resnets"]):
        inv_resnet(sd, f"decoder.mid_block.resnets.{j}", r)
    a, prefix = tree["mid"]["attn"], "decoder.mid_block.attentions.0"
    inv_norm(sd, f"{prefix}.group_norm", a["norm"])
    inv_attn(sd, prefix, a)
    for i, blk in enumerate(tree["up_blocks"]):
        for j, r in enumerate(blk["resnets"]):
            inv_resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}", r)
        if "upsample" in blk:
            inv_conv(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv",
                     blk["upsample"])
    return sd


def clip_sd(tree):
    sd = {"text_model.embeddings.token_embedding.weight":
          tree["token_embedding"]["embedding"],
          "text_model.embeddings.position_embedding.weight":
          tree["position_embedding"]["embedding"]}
    for i, lp in enumerate(tree["layers"]):
        b = f"text_model.encoder.layers.{i}"
        inv_norm(sd, f"{b}.layer_norm1", lp["ln1"])
        inv_norm(sd, f"{b}.layer_norm2", lp["ln2"])
        for n, name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                        ("out", "out_proj")):
            inv_linear(sd, f"{b}.self_attn.{name}", lp[n])
        inv_linear(sd, f"{b}.mlp.fc1", lp["fc1"])
        inv_linear(sd, f"{b}.mlp.fc2", lp["fc2"])
    inv_norm(sd, "text_model.final_layer_norm", tree["final_ln"])
    return sd


# a text tower with heads of dim 64, as every CLIP text tower has (the
# entry point derives the heads from the width), and a UNet that attends to
# its output: a context of 4 tokens of width 128
TEXT = JU.CLIPTextConfig(vocab_size=64, hidden=128, layers=2, heads=2,
                         mlp_dim=256, max_len=4)
UNET = dataclasses.replace(JU.TINY_UNET, cross_attention_dim=128)
DECODER = dataclasses.replace(
    TU.TINY_UNCLIP, text_ctx_dim=128,
    unet=dataclasses.replace(TU.TINY_UNET, cross_attention_dim=128))


@pytest.fixture(scope="module")
def unclip_trees():
    unet = _seeded_tree(JU.init_unet, UNET, 4)
    vae = _seeded_tree(JU.init_vae_decoder, JU.TINY_VAE, 5)
    text = _seeded_tree(JU.init_clip_text, TEXT, 6)
    norm = {"mean": Rand(7)(1, 5), "std": np.abs(Rand(8)(1, 5)) + 0.5}
    return unet, vae, text, norm


@pytest.mark.parametrize("family", ["unet", "vae", "text_encoder",
                                    "image_normalizer"])
def test_unclip_equals_seed_tpu(unclip_trees, family):
    """Each unCLIP converter equals seed_tpu's after the bridge's conv step,
    and both equal the tree the state dict was written from."""
    unet, vae, text, norm = unclip_trees
    tree, sd, fn, jfn = {
        "unet": (unet, unet_sd(unet), TUC.convert_unet, JUC.convert_unet),
        "vae": (vae, vae_sd(vae), TUC.convert_vae_decoder,
                JUC.convert_vae_decoder),
        "text_encoder": (text, clip_sd(text), TUC.convert_clip_text,
                         JUC.convert_clip_text),
        "image_normalizer": (norm, norm, TUC.convert_image_normalizer,
                             JUC.convert_image_normalizer)}[family]
    got = fn(sd, device="cpu")
    assert_same_tree(got, via_bridge(jfn(sd), convs=True))
    if family != "image_normalizer":
        assert_same_tree(got, via_bridge(tree, convs=True))


def _write(directory, sd, name):
    os.makedirs(directory, exist_ok=True)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               os.path.join(directory, name))


def test_cli_unclip_round_trip(unclip_trees, tmp_path):
    """``python3 -m seed_tpu_torch.convert unclip`` on a diffusers-style
    directory (one file of each kind), read back with restore_checkpoint:
    the converters' trees, the empty-prompt context from the text tower, and
    a decoder that runs on it."""
    unet, vae, text, norm = unclip_trees
    src, dst = tmp_path / "diffusers", tmp_path / "out"
    _write(src / "unet", unet_sd(unet), "diffusion_pytorch_model.bin")
    from safetensors.torch import save_file
    os.makedirs(src / "vae")
    save_file({k: torch.from_numpy(np.array(v)) for k, v in vae_sd(vae).items()},
              str(src / "vae" / "diffusion_pytorch_model.safetensors"))
    _write(src / "text_encoder", clip_sd(text), "pytorch_model.bin")
    _write(src / "image_normalizer", norm, "normalizer.pt")
    proc = subprocess.run(
        [sys.executable, "-m", "seed_tpu_torch.convert", "unclip", str(src),
         str(dst), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    tree = restore_checkpoint(str(dst), device="cpu")
    assert set(tree) == {"unet", "vae", "text_encoder", "image_normalizer",
                         "empty_prompt_embeds"}
    assert_same_tree(tree["unet"], TUC.convert_unet(unet_sd(unet), device="cpu"))
    assert_same_tree(tree["vae"], TUC.convert_vae_decoder(vae_sd(vae), device="cpu"))
    ids = np.asarray([[CLI.CLIP_BOS, CLI.CLIP_EOS, 0, 0]])   # clipped to 63
    want = jax.jit(JU.clip_text_apply, static_argnums=(2,))(text, ids, TEXT)
    np.testing.assert_allclose(tree["empty_prompt_embeds"].numpy(),
                               np.asarray(want), rtol=0, atol=1e-5)
    img = TU.UnCLIPDecoder(tree, DECODER, num_inference_steps=2,
                           device="cpu").generate(np.ones((1, 5), np.float32))
    assert img.shape == (1, 16, 16, 3) and np.isfinite(img).all()


@pytest.mark.parametrize("family", ["quantizer", "llama", "lora"])
def test_cli_families_round_trip(family, tmp_path):
    sd = {"quantizer": lambda: quantizer_sd("released"), "llama": llama_sd,
          "lora": lora_sd}[family]()
    src = tmp_path / "src"
    _write(src, sd, "model.bin")
    CLI.main([family, str(src), str(tmp_path / "out"), "--device", "cpu"])
    got = restore_checkpoint(str(tmp_path / "out"), device="cpu")
    want = {"quantizer": lambda: TC.convert_quantizer(sd, device="cpu"),
            "llama": lambda: TC.convert_llama(sd, 384, device="cpu"),
            "lora": lambda: TC.convert_lora(sd, device="cpu")}[family]()
    assert_same_tree(got, want)


def test_converters_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TC.convert_lora(lora_sd())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TUC.convert_image_normalizer({"mean": np.zeros(3), "std": np.ones(3)})
