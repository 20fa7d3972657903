"""diffusers stable-diffusion-2-1-unclip checkpoints -> the port's unCLIP
trees (counterpart of seed_tpu/convert/unclip_convert.py).

The de-tokenizer's weight family: UNet2DConditionModel, the AutoencoderKL
decoder, CLIPTextModel and StableUnCLIPImageNormalizer. Layouts:

- torch conv [O, I, kh, kw] stays OIHW, stored channels_last (seed_tpu
  turns it into HWIO; ``bridge.convs_to_oihw`` turns that back)
- torch linear [O, I] -> kernel [I, O]
- GroupNorm / LayerNorm weight, bias -> scale, bias
- transformer blocks and CLIP layers -> lists, as seed_tpu keeps them
"""
from __future__ import annotations

import re
from typing import Any, Dict

import torch

from .torch_convert import _linear, _ln, _num_layers, host, place

_gn = _ln       # GroupNorm and LayerNorm name their parameters alike


def _conv(sd, prefix):
    return {"kernel": sd[f"{prefix}.weight"].contiguous(
                memory_format=torch.channels_last),
            "bias": sd[f"{prefix}.bias"]}


def _resnet(sd, p):
    out = {"norm1": _gn(sd, f"{p}.norm1"), "conv1": _conv(sd, f"{p}.conv1"),
           "norm2": _gn(sd, f"{p}.norm2"), "conv2": _conv(sd, f"{p}.conv2")}
    if f"{p}.time_emb_proj.weight" in sd:
        out["time_emb_proj"] = _linear(sd, f"{p}.time_emb_proj")
    if f"{p}.conv_shortcut.weight" in sd:
        out["conv_shortcut"] = _conv(sd, f"{p}.conv_shortcut")
    return out


def _attention(sd, p):
    return {"to_q": _linear(sd, f"{p}.to_q"),
            "to_k": _linear(sd, f"{p}.to_k"),
            "to_v": _linear(sd, f"{p}.to_v"),
            "to_out": _linear(sd, f"{p}.to_out.0")}


def _transformer_block(sd, p):
    return {
        "norm1": _ln(sd, f"{p}.norm1"),
        "attn1": _attention(sd, f"{p}.attn1"),
        "norm2": _ln(sd, f"{p}.norm2"),
        "attn2": _attention(sd, f"{p}.attn2"),
        "norm3": _ln(sd, f"{p}.norm3"),
        "ff": {"proj": _linear(sd, f"{p}.ff.net.0.proj"),
               "out": _linear(sd, f"{p}.ff.net.2")},
    }


def _spatial_transformer(sd, p):
    n_blocks = _num_layers(sd, re.escape(p) + r"\.transformer_blocks\.(\d+)\.")
    return {
        "norm": _gn(sd, f"{p}.norm"),
        "proj_in": _linear(sd, f"{p}.proj_in"),
        "blocks": [_transformer_block(sd, f"{p}.transformer_blocks.{i}")
                   for i in range(n_blocks)],
        "proj_out": _linear(sd, f"{p}.proj_out"),
    }


def _level(sd, b, sample_key):
    """One down or up block: resnets, attentions, its down/upsampler."""
    n_res = _num_layers(sd, re.escape(b) + r"\.resnets\.(\d+)\.")
    n_attn = _num_layers(sd, re.escape(b) + r"\.attentions\.(\d+)\.")
    block = {"resnets": [_resnet(sd, f"{b}.resnets.{j}") for j in range(n_res)],
             "attentions": [_spatial_transformer(sd, f"{b}.attentions.{j}")
                            for j in range(n_attn)]}
    sampler = "downsamplers" if sample_key == "downsample" else "upsamplers"
    if f"{b}.{sampler}.0.conv.weight" in sd:
        block[sample_key] = _conv(sd, f"{b}.{sampler}.0.conv")
    return block


def convert_unet(sd, device="cuda") -> Dict[str, Any]:
    sd = host(sd)
    p: Dict[str, Any] = {
        "conv_in": _conv(sd, "conv_in"),
        "time_embedding": {"linear_1": _linear(sd, "time_embedding.linear_1"),
                           "linear_2": _linear(sd, "time_embedding.linear_2")},
        "down_blocks": [], "up_blocks": [],
        "conv_norm_out": _gn(sd, "conv_norm_out"),
        "conv_out": _conv(sd, "conv_out"),
    }
    if "class_embedding.linear_1.weight" in sd:
        p["class_embedding"] = {
            "linear_1": _linear(sd, "class_embedding.linear_1"),
            "linear_2": _linear(sd, "class_embedding.linear_2")}
    p["down_blocks"] = [_level(sd, f"down_blocks.{i}", "downsample")
                        for i in range(_num_layers(sd, r"down_blocks\.(\d+)\."))]
    p["mid_block"] = {
        "resnets": [_resnet(sd, "mid_block.resnets.0"),
                    _resnet(sd, "mid_block.resnets.1")],
        "attentions": [_spatial_transformer(sd, "mid_block.attentions.0")],
    }
    p["up_blocks"] = [_level(sd, f"up_blocks.{i}", "upsample")
                      for i in range(_num_layers(sd, r"up_blocks\.(\d+)\."))]
    return place(p, device)


def convert_vae_decoder(sd, device="cuda") -> Dict[str, Any]:
    sd = host(sd)
    attn = "decoder.mid_block.attentions.0"
    p: Dict[str, Any] = {
        "post_quant_conv": _conv(sd, "post_quant_conv"),
        "conv_in": _conv(sd, "decoder.conv_in"),
        "mid": {"resnets": [_resnet(sd, "decoder.mid_block.resnets.0"),
                            _resnet(sd, "decoder.mid_block.resnets.1")],
                "attn": {"norm": _gn(sd, f"{attn}.group_norm"),
                         **_attention(sd, attn)}},
        "up_blocks": [],
        "conv_norm_out": _gn(sd, "decoder.conv_norm_out"),
        "conv_out": _conv(sd, "decoder.conv_out"),
    }
    for i in range(_num_layers(sd, r"decoder\.up_blocks\.(\d+)\.")):
        b = f"decoder.up_blocks.{i}"
        n_res = _num_layers(sd, re.escape(b) + r"\.resnets\.(\d+)\.")
        block = {"resnets": [_resnet(sd, f"{b}.resnets.{j}")
                             for j in range(n_res)]}
        if f"{b}.upsamplers.0.conv.weight" in sd:
            block["upsample"] = _conv(sd, f"{b}.upsamplers.0.conv")
        p["up_blocks"].append(block)
    return place(p, device)


def convert_clip_text(sd, device="cuda") -> Dict[str, Any]:
    sd = {k.removeprefix("text_model."): v for k, v in host(sd).items()}
    layers = []
    for i in range(_num_layers(sd, r"encoder\.layers\.(\d+)\.")):
        b = f"encoder.layers.{i}"
        layers.append({
            "ln1": _ln(sd, f"{b}.layer_norm1"),
            "q": _linear(sd, f"{b}.self_attn.q_proj"),
            "k": _linear(sd, f"{b}.self_attn.k_proj"),
            "v": _linear(sd, f"{b}.self_attn.v_proj"),
            "out": _linear(sd, f"{b}.self_attn.out_proj"),
            "ln2": _ln(sd, f"{b}.layer_norm2"),
            "fc1": _linear(sd, f"{b}.mlp.fc1"),
            "fc2": _linear(sd, f"{b}.mlp.fc2"),
        })
    return place({
        "token_embedding": {"embedding": sd["embeddings.token_embedding.weight"]},
        "position_embedding": {
            "embedding": sd["embeddings.position_embedding.weight"]},
        "layers": layers,
        "final_ln": _ln(sd, "final_layer_norm"),
    }, device)


def convert_image_normalizer(sd, device="cuda") -> Dict[str, Any]:
    sd = host(sd)
    return place({"mean": sd["mean"].reshape(-1),
                  "std": sd["std"].reshape(-1)}, device)
