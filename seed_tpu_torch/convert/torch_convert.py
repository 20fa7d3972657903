"""Released PyTorch checkpoints -> the port's param trees (counterpart of
seed_tpu/convert/torch_convert.py).

Name maps of the reference's checkpoint families:

1. ``seed_quantizer.pt`` — the Blip2QformerQuantizer state dict
2. HF LLaMA (vicuna-7b / llama2-13b) — ``model.layers.*`` keys
3. PEFT LoRA adapters — ``lora_A`` / ``lora_B`` per projection
4. torchvision ``inception_v3`` — the FID / IS feature extractor
(the unCLIP family is ``unclip_convert``).

Each converter returns the tree that seed_tpu's converter returns, carried
across as ``bridge.from_seed_tpu`` (and, for convs, ``bridge.convs_to_oihw``)
would carry it, built straight from the state dict:

- torch ``nn.Linear.weight`` [out, in] -> kernel [in, out] (transposed)
- the conv patch embedding [D, C, P, P] -> kernel [(P, P, C), D]
- per-layer module lists -> lists of per-layer dicts (seed_tpu stacks them)
- conv kernels keep torch's OIHW, stored channels_last
- embedding / lm_head vocabulary rows -> padded when asked

The state dict may hold numpy arrays or tensors; the result is tensors on
``device`` (the card by default).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..eval.inception import BN_EPS, INCEPTION_CONVS
from ..utils.tree import tree_map


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A .pt / .bin / .safetensors file -> CPU tensors, floating ones in fp32
    (as seed_tpu loads them)."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file
        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
            sd = sd["model"]  # LAVIS-style {"model": state_dict, "optimizer": ...}
    return {k: v.float() if v.is_floating_point() else v for k, v in sd.items()}


def host(sd) -> Dict[str, torch.Tensor]:
    """Every value of ``sd`` as a CPU tensor (numpy arrays are copied)."""
    return {k: v if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.array(v)) for k, v in sd.items()}


def place(tree: Any, device) -> Any:
    """Every tensor of ``tree`` on ``device``, in memory of its own."""
    device = resolve_device(device)
    return tree_map(lambda t: t.to(device, copy=True), tree)


def _t(w: torch.Tensor) -> torch.Tensor:          # torch Linear -> kernel
    return w.T.contiguous()


def _ln(sd, prefix):
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _linear(sd, prefix, bias=True):
    p = {"kernel": _t(sd[f"{prefix}.weight"])}
    if bias and f"{prefix}.bias" in sd:
        p["bias"] = sd[f"{prefix}.bias"]
    return p


def _num_layers(sd, pattern):
    pat = re.compile(pattern)
    idx = {int(m.group(1)) for k in sd if (m := pat.match(k))}
    return max(idx) + 1 if idx else 0


# ------------------------ 1. SEED quantizer --------------------------------

def _convert_vit_block(sd, p):
    """EVA block (q/v-only bias) or plain block (full qkv bias)."""
    attn = {"qkv": {"kernel": _t(sd[f"{p}.attn.qkv.weight"])},
            "proj": _linear(sd, f"{p}.attn.proj")}
    if f"{p}.attn.qkv.bias" in sd:
        attn["qkv"]["bias"] = sd[f"{p}.attn.qkv.bias"]
    elif f"{p}.attn.q_bias" in sd:
        attn["q_bias"] = sd[f"{p}.attn.q_bias"]
        attn["v_bias"] = sd[f"{p}.attn.v_bias"]
    return {
        "norm1": _ln(sd, f"{p}.norm1"),
        "attn": attn,
        "norm2": _ln(sd, f"{p}.norm2"),
        "mlp": {"fc1": _linear(sd, f"{p}.mlp.fc1"),
                "fc2": _linear(sd, f"{p}.mlp.fc2")},
    }


def _convert_patch_embed(sd, prefix):
    w = sd[f"{prefix}.proj.weight"]            # [D, C, P, P]
    p = {"kernel": w.permute(2, 3, 1, 0).reshape(-1, w.shape[0]).contiguous()}
    if f"{prefix}.proj.bias" in sd:
        p["bias"] = sd[f"{prefix}.proj.bias"]
    return p


def _convert_qformer_layer(sd, p, with_text=False):
    def attn_block(a_prefix):
        return {
            "q": _linear(sd, f"{a_prefix}.self.query"),
            "k": _linear(sd, f"{a_prefix}.self.key"),
            "v": _linear(sd, f"{a_prefix}.self.value"),
            "out": _linear(sd, f"{a_prefix}.output.dense"),
            "norm": _ln(sd, f"{a_prefix}.output.LayerNorm"),
        }

    layer = {
        "self": attn_block(f"{p}.attention"),
        "ffn_q": {"fc1": _linear(sd, f"{p}.intermediate_query.dense"),
                  "fc2": _linear(sd, f"{p}.output_query.dense"),
                  "norm": _ln(sd, f"{p}.output_query.LayerNorm")},
    }
    if f"{p}.crossattention.self.query.weight" in sd:
        layer["cross"] = attn_block(f"{p}.crossattention")
    if with_text and f"{p}.intermediate.dense.weight" in sd:
        layer["ffn_t"] = {"fc1": _linear(sd, f"{p}.intermediate.dense"),
                          "fc2": _linear(sd, f"{p}.output.dense"),
                          "norm": _ln(sd, f"{p}.output.LayerNorm")}
    return layer


def _qformer(sd, prefix, tokens, with_text=False):
    n = _num_layers(sd, re.escape(prefix) + r"\.bert\.encoder\.layer\.(\d+)\.")
    return {
        "query_tokens": sd[tokens],
        "embeddings": {"norm": _ln(sd, f"{prefix}.bert.embeddings.LayerNorm")},
        "layers": [_convert_qformer_layer(
            sd, f"{prefix}.bert.encoder.layer.{i}", with_text)
            for i in range(n)],
    }


def convert_quantizer(sd, with_text: bool = False, device="cuda") -> Dict[str, Any]:
    """seed_quantizer.pt state dict -> init_seed_tokenizer()-shaped tree."""
    sd = host(sd)
    n_vit = _num_layers(sd, r"visual_encoder\.blocks\.(\d+)\.")
    n_img = _num_layers(sd, r"blocks_image\.(\d+)\.")

    params = {
        "vit": {
            "patch_embed": _convert_patch_embed(sd, "visual_encoder.patch_embed"),
            "cls_token": sd["visual_encoder.cls_token"],
            "pos_embed": sd["visual_encoder.pos_embed"],
            "blocks": [_convert_vit_block(sd, f"visual_encoder.blocks.{i}")
                       for i in range(n_vit)],
        },
        "ln_vision": _ln(sd, "ln_vision"),
        "qformer": _qformer(sd, "Qformer", "query_tokens", with_text),
        "encode_task": {"fc1": _linear(sd, "encode_task_layer.0"),
                        "fc2": _linear(sd, "encode_task_layer.2")},
        "vq": {"codebook": sd["quantize.embedding.weight"]},
        "decode_task": {"fc1": _linear(sd, "decode_task_layer.0"),
                        "fc2": _linear(sd, "decode_task_layer.2")},
        "pos_embed_image": sd["pos_embed_image"],
        "blocks_image": [_convert_vit_block(sd, f"blocks_image.{i}")
                         for i in range(n_img)],
        "distill_image_proj": _linear(sd, "distill_image_proj"),
    }
    if "reverse_tokens" in sd:
        # Reverse Q-Former distill head (use_qformer_image=True)
        params["reverse_qformer"] = _qformer(sd, "Reverse_Qformer",
                                             "reverse_tokens")
    else:
        params["image_down"] = {
            "fc1": _linear(sd, "image_down.0", bias=False),
            "fc2": _linear(sd, "image_down.2", bias=False),
            "fc3": _linear(sd, "image_down.4", bias=False)}
    if "pos_embed" in sd:  # recon_s stack (stage-2 training artifacts)
        n_rec = _num_layers(sd, r"blocks\.(\d+)\.")
        if n_rec:
            params["pos_embed"] = sd["pos_embed"]
            params["blocks"] = [_convert_vit_block(sd, f"blocks.{i}")
                                for i in range(n_rec)]
    return place(params, device)


# ------------------------ 2. HF LLaMA --------------------------------------

def convert_llama(sd, padded_vocab: Optional[int] = None,
                  device="cuda") -> Dict[str, Any]:
    """HF llama state dict -> init_llama()-shaped tree (a list of layers)."""
    sd = {k.removeprefix("model."): v for k, v in host(sd).items()}
    n = _num_layers(sd, r"layers\.(\d+)\.")

    def layer(i):
        p = f"layers.{i}"
        return {
            "input_layernorm": {"scale": sd[f"{p}.input_layernorm.weight"]},
            "q_proj": _linear(sd, f"{p}.self_attn.q_proj", bias=False),
            "k_proj": _linear(sd, f"{p}.self_attn.k_proj", bias=False),
            "v_proj": _linear(sd, f"{p}.self_attn.v_proj", bias=False),
            "o_proj": _linear(sd, f"{p}.self_attn.o_proj", bias=False),
            "post_attention_layernorm": {
                "scale": sd[f"{p}.post_attention_layernorm.weight"]},
            "gate_proj": _linear(sd, f"{p}.mlp.gate_proj", bias=False),
            "up_proj": _linear(sd, f"{p}.mlp.up_proj", bias=False),
            "down_proj": _linear(sd, f"{p}.mlp.down_proj", bias=False),
        }

    embed = sd["embed_tokens.weight"]
    head = _t(sd["lm_head.weight"])
    if padded_vocab and padded_vocab > embed.shape[0]:
        pad = padded_vocab - embed.shape[0]
        embed = torch.cat([embed, embed.new_zeros((pad, embed.shape[1]))], 0)
        head = torch.cat([head, head.new_zeros((head.shape[0], pad))], 1)
    return place({
        "embed_tokens": {"embedding": embed},
        "layers": [layer(i) for i in range(n)],
        "norm": {"scale": sd["norm.weight"]},
        "lm_head": {"kernel": head},
    }, device)


# ------------------------ 3. PEFT LoRA -------------------------------------

def convert_lora(sd, alpha: float = 32.0, r: Optional[float] = None,
                 device="cuda") -> Dict[str, Any]:
    """PEFT adapter state dict -> the port's LoRA tree (train/lora.py).

    PEFT keys look like
    ``base_model.model.model.layers.{i}.self_attn.q_proj.lora_A.weight``
    with lora_A [r, in], lora_B [out, r]; merged delta = B@A * alpha/r. The
    port names one adapter per layer, ``layers/{i}/{proj}/kernel``, with
    a [in, r] and b [r, out].
    """
    pat = re.compile(
        r"layers\.(\d+)\.(?:self_attn|mlp)\.(\w+_proj)\.lora_([AB])\.weight$")
    found: Dict[str, Dict[int, Dict[str, torch.Tensor]]] = {}
    for k, v in host(sd).items():
        m = pat.search(k)
        if not m:
            continue
        i, proj, ab = int(m.group(1)), m.group(2), m.group(3)
        found.setdefault(proj, {}).setdefault(i, {})[ab] = v

    adapters = {}
    rank = None
    for proj, per_layer in found.items():
        for i in range(max(per_layer) + 1):
            a, b = _t(per_layer[i]["A"]), _t(per_layer[i]["B"])
            rank = a.shape[-1]
            adapters[f"layers/{i}/{proj}/kernel"] = {"a": a, "b": b}
    r = r if r is not None else (rank or 16)
    return place({"adapters": adapters,
                  "scale": torch.tensor(alpha / r, dtype=torch.float32)}, device)


# ------------------------ 4. torchvision inception_v3 ----------------------

def convert_inception_torch(sd, dtype=torch.float32,
                            device="cuda") -> Dict[str, Any]:
    """torchvision ``inception_v3`` state dict -> the inception tree of the
    FID pool3 feature extractor (``eval.inception``).

    Each BasicConv2d's eval-mode BatchNorm (eps=1e-3) is folded, in float64,
    into a per-channel (scale, bias):
        scale = gamma / sqrt(running_var + eps)
        bias  = beta - running_mean * scale
    The conv weight keeps torch's OIHW (channels_last). The 1000-way fc head
    is converted when present (the Inception Score runs the full net);
    aux-classifier keys are ignored (eval mode never runs them).
    """
    sd = host(sd)
    params = {}
    for name, (cin, cout, k, _, _) in INCEPTION_CONVS.items():
        w = sd[f"{name}.conv.weight"]
        if tuple(w.shape) != (cout, cin, *k):
            raise ValueError(f"{name}.conv.weight is {tuple(w.shape)}, "
                             f"expected {(cout, cin, *k)}")
        gamma, beta, mean, var = (sd[f"{name}.bn.{s}"].double() for s in (
            "weight", "bias", "running_mean", "running_var"))
        scale = gamma / torch.sqrt(var + BN_EPS)
        params[name] = {
            "kernel": w.to(dtype).contiguous(memory_format=torch.channels_last),
            "scale": scale.to(dtype),
            "bias": (beta - mean * scale).to(dtype),
        }
    if "fc.weight" in sd:
        w = sd["fc.weight"]
        if tuple(w.shape) != (1000, 2048):
            raise ValueError(f"fc.weight is {tuple(w.shape)}, expected "
                             "(1000, 2048)")
        params["fc"] = {"kernel": _t(w).to(dtype),
                        "bias": sd["fc.bias"].to(dtype)}
    return place(params, device)
