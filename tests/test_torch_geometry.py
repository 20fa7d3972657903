"""``python3 -m seed_tpu_torch.scripts.check_full_geometry`` against the
spec arithmetic of seed_tpu's scripts/check_full_geometry.py, on the CPU.

seed_tpu's side: its abstract trees (``jax.eval_shape`` of ``init_llama``,
``init_lora`` and the AdamW state), its ``make_param_specs`` at
``auto_mesh(tp=2)`` on the 8 virtual CPU devices, and each leaf's shard
shape from ``NamedSharding.shard_shape``. The port's parameter bytes per rank
equal seed_tpu's, and its AdamW moments equal seed_tpu's moments of the
leaves the port trains (the adapters under LoRA: the port's trainer closes
over the frozen base, where the script hands the base to the optimizer too).
At a tiny config the count is also held against the argument bytes of
seed_tpu's compiled, sharded training step, less the batch and the rng.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from seed_tpu.models import llama as JM
from seed_tpu.parallel import LLAMA_TP_RULES, auto_mesh
from seed_tpu.parallel.mesh import DATA_AXIS, FSDP_AXIS
from seed_tpu.parallel.partition import make_param_specs
from seed_tpu.train import (adamw, cosine_with_floor, cross_entropy,
                            init_lora)
from seed_tpu.train.trainer import TrainState, make_train_step
from seed_tpu_torch.models import llama as TM
from seed_tpu_torch.scripts import check_full_geometry as G

MODELS = {"8b": JM.SEED_LLAMA_8B, "14b": JM.SEED_LLAMA_14B}


def _is_spec(x):
    return isinstance(x, P)


def seed_tpu_state(cfg, full):
    """(params, AdamW state) as abstract trees, as the script builds them."""
    base = jax.eval_shape(lambda k: JM.init_llama(k, cfg, jnp.bfloat16),
                          jax.random.PRNGKey(0))
    params = base if full else {"base": base, "lora": jax.eval_shape(
        lambda k: init_lora(k, base, r=16, alpha=32), jax.random.PRNGKey(1))}
    opt = adamw(cosine_with_floor(1.5e-4, 500, 30000, 0.05), b1=0.9, b2=0.95,
                eps=1e-5, weight_decay=0.05, clip_norm=1.0, params=params)
    return params, opt, jax.eval_shape(opt.init, params)


def shard_bytes(tree, mesh, keep=lambda path: True):
    """Bytes one device holds of ``tree`` laid out by LLAMA_TP_RULES."""
    specs = make_param_specs(tree, mesh, LLAMA_TP_RULES)
    total = 0
    for (path, leaf), spec in zip(
            jax.tree_util.tree_flatten_with_path(tree)[0],
            jax.tree.leaves(specs, is_leaf=_is_spec)):
        if keep(jax.tree_util.keystr(path)):
            shape = NamedSharding(mesh, spec).shard_shape(leaf.shape)
            total += int(np.prod(shape)) * leaf.dtype.itemsize
    return total


def _moment(path):
    return ".mu" in path or ".nu" in path


@pytest.mark.parametrize("full", [False, True], ids=["lora", "full"])
@pytest.mark.parametrize("model", ["8b", "14b"])
def test_bytes_per_rank_equal_seed_tpu_specs(model, full):
    """8B / 14B, LoRA and --full, tp=2 x fsdp=4: parameter and moment bytes
    per rank equal seed_tpu's; every spec divides; gradients are the
    trained leaves'; the state fits one H100."""
    mesh = auto_mesh(tp=2)
    params, _, opt_state = seed_tpu_state(MODELS[model], full)
    g = G.geometry(model, full, tp=2, devices=8, batch=8, seq=1024)
    assert g["mesh"] == {"data": 1, "fsdp": 4, "pipe": 1, "tensor": 2}
    assert g["undivided"] == []
    trained = (lambda p: True) if full else (lambda p: "'lora'" in p)
    assert g["bytes"]["params"] == shard_bytes(params, mesh)
    assert g["bytes"]["adam_moments"] == shard_bytes(
        opt_state, mesh, lambda p: _moment(p) and trained(p))
    assert g["bytes"]["grads"] * 2 == g["bytes"]["adam_moments"]
    assert g["bytes"]["batch"] == 8 * 1024 * 12 // 4
    assert g["total_bytes"] < G.H100_BYTES


def test_undivided_spec_is_reported():
    """tp=8 does not divide a kv width of one head of 12: the spec is
    reported and counted at its ceiling share."""
    cfg = TM.LlamaConfig(vocab_size=270, dim=48, layers=1, heads=4,
                         kv_heads=1, ffn_dim=128)
    parts, undivided = G.state_bytes(cfg, True, G.mesh_sizes(8, 8))
    assert undivided == ["layers/0/k_proj/kernel dim 1 (12) over tensor (8)",
                         "layers/0/v_proj/kernel dim 1 (12) over tensor (8)"]
    whole, _ = G.state_bytes(cfg, True, G.mesh_sizes(8, 1))
    # q, k, v, o, gate, up, down of one layer: 48 x 48, 48 x 12 (twice,
    # 2 columns a rank), ...; the two kv kernels hold 48 x 2 each, not 48 x 1.5
    assert parts["params"] * 8 > whole["params"]


def test_tiny_step_argument_bytes_match_compiled_seed_tpu():
    """At TINY_LLAMA, --full, tp=2 x fsdp=4: the port's parameter and
    moment bytes, with the state's scalar counters, equal the argument bytes
    per device of seed_tpu's compiled sharded step less its batch and rng
    (kept as an argument although the loss does not read it)."""
    cfg = JM.TINY_LLAMA
    mesh = auto_mesh(tp=2)
    params, opt, opt_state = seed_tpu_state(cfg, full=True)

    def loss_fn(p, batch, rng):
        logits = JM.forward(p, batch["input_ids"], cfg,
                            attn_mask=batch["attention_mask"], remat=True)
        return cross_entropy(logits[:, :-1], batch["labels"][:, 1:])

    shard = lambda specs: jax.tree.map(lambda s: NamedSharding(mesh, s),
                                       specs, is_leaf=_is_spec)
    state_specs = TrainState(P(), make_param_specs(params, mesh,
                                                   LLAMA_TP_RULES),
                             make_param_specs(opt_state, mesh,
                                              LLAMA_TP_RULES))
    B, S = 8, 64
    batch = {"input_ids": jax.ShapeDtypeStruct((B, S), jnp.int32),
             "attention_mask": jax.ShapeDtypeStruct((B, S), jnp.bool_),
             "labels": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    state = TrainState(jax.ShapeDtypeStruct((), jnp.int32), params, opt_state)
    step = jax.jit(make_train_step(loss_fn, opt),
                   in_shardings=(shard(state_specs), NamedSharding(
                       mesh, P((DATA_AXIS, FSDP_AXIS))), None),
                   out_shardings=(shard(state_specs), None),
                   donate_argnums=(0,), keep_unused=True)
    mem = step.lower(state, batch, jax.ShapeDtypeStruct(
        (2,), jnp.uint32)).compile().memory_analysis()
    parts, undivided = G.state_bytes(TM.TINY_LLAMA, True, G.mesh_sizes(8, 2))
    assert undivided == []
    scalars = 4 + sum(leaf.dtype.itemsize for leaf in jax.tree.leaves(
        opt_state) if leaf.shape == ())
    batch_bytes = B * S * (4 + 1 + 4) // 4
    assert (parts["params"] + parts["adam_moments"] + scalars
            == mem.argument_size_in_bytes - batch_bytes - 2 * 4)
