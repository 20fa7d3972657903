"""The port's two training entry points, in process on the CPU
(``--device cpu``): ``python3 -m seed_tpu_torch.train.train_llm`` and
``python3 -m seed_tpu_torch.train.train_tokenizer``, against what
scripts/train_llm.py and scripts/train_tokenizer.py do with seed_tpu.

Contracts: each run ends with "training done"; resume starts from the saved
step; checkpoints hold exactly the paths the scripts' trainable patterns
pick on seed_tpu's own init tree; under ``--lora`` the base is bit-identical
after training; the port's loss on one batch equals the script's loss_fn
on the same weights within 1e-5 (fp32).
"""
import io
import json
import pickle
import re
import subprocess
import sys
import tarfile
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seed_tpu.eval.metrics import caption_metrics
from seed_tpu.models import llama as JM
from seed_tpu.models import qformer as JQ
from seed_tpu.models import seed_tokenizer as JST
from seed_tpu.train import lora as JLORA
from seed_tpu.train import losses as JLOSS
from seed_tpu.train import tokenizer_training as JTT
from seed_tpu.utils.checkpoint import filter_tree as j_filter_tree
from seed_tpu_torch import bridge
from seed_tpu_torch.train import train_llm, train_tokenizer
from seed_tpu_torch.train.tokenizer_training import (STAGE1_TRAINABLE,
                                                     STAGE2_TRAINABLE)
from seed_tpu_torch.utils.checkpoint import restore_checkpoint
from seed_tpu_torch.utils.tree import leaves_with_path

REPO = Path(__file__).resolve().parents[1]


def write_shard(path, records):
    with tarfile.open(path, "w") as tf:
        for i, rec in enumerate(records):
            data = pickle.dumps(rec)
            info = tarfile.TarInfo(f"k{i}.pkl")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


def caption_records(n=24):
    return [{"image_ids": [int(c) for c in
                           np.random.RandomState(i).randint(0, 8192, 8)],
             "text": f"a photo number {i}"} for i in range(n)]


def qa_records(n=24):
    """Text-only SFT records: every id inside TINY_LLAMA's 270."""
    return [{"question": f"what is {i}?", "answer": f"thing {i}"}
            for i in range(n)]


def write_img_tar(path, n=8, size=28):
    from PIL import Image
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            arr = np.random.RandomState(i).randint(0, 255, (size, size, 3),
                                                   dtype=np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="JPEG")
            for ext, data in (("jpg", buf.getvalue()),
                              ("txt", f"caption {i}".encode())):
                info = tarfile.TarInfo(f"k{i}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


def fingerprint(tree):
    return {p: x.clone() for p, x in leaves_with_path(tree)}


def paths(tree):
    return {p: tuple(x.shape) for p, x in leaves_with_path(tree)}


# ----------------------------------------------------------------- LLM

def llm_argv(tmp_path, mode, steps, *extra):
    (tmp_path / "eval.jsonl").write_text("".join(
        json.dumps({"input_ids": [3 + i, 10, 20], "image_id": i}) + "\n"
        for i in range(3)))
    (tmp_path / "ann.json").write_text(json.dumps(
        {str(i): [f"caption {i}"] for i in range(3)}))
    return ["--data", str(tmp_path / "data_*.tar"), "--mode", mode,
            "--model", "tiny", "--steps", str(steps), "--batch-size", "4",
            "--grad-accum", "2", "--max-length", "48", "--save-steps", "2",
            "--log-steps", "1", "--warmup", "1", "--lr", "1e-2",
            "--eval-data", str(tmp_path / "eval.jsonl"),
            "--eval-annotations", str(tmp_path / "ann.json"),
            "--eval-batch-size", "2", "--eval-max-new-tokens", "3",
            "--eval-num-beams", "2", "--output", str(tmp_path / "out"),
            "--device", "cpu", *extra]


@pytest.mark.parametrize("mode", ["pretrain", "sft"])
def test_train_llm_save_resume_eval(tmp_path, capsys, mode):
    write_shard(tmp_path / "data_000.tar",
                caption_records() if mode == "pretrain" else qa_records())
    args = train_llm.parse_args(llm_argv(tmp_path, mode, 3))
    setup = train_llm.build(args)
    base0 = fingerprint(setup.base)
    lora0 = fingerprint(setup.trainer.state.params)
    rec = train_llm.run(args, setup)
    out = capsys.readouterr().out
    assert "training done" in out and "eval_CIDEr" in out
    assert rec["step"] == 3 and [e["step"] for e in rec["evals"]] == [2, 3]
    # --lora: the base is bit-identical, the adapters moved
    assert all(torch.equal(x, base0[p]) for p, x in
               leaves_with_path(setup.base))
    assert any(not torch.equal(x, lora0[p]) for p, x in
               leaves_with_path(setup.trainer.state.params))
    losses = [r["loss"] for r in rec["log"] if "loss" in r]
    assert len(losses) == 3
    if mode == "sft":            # text only: every label inside the vocab
        assert all(np.isfinite(losses))
    # checkpoints: the adapter tree only, the full state under state/
    saved = restore_checkpoint(str(tmp_path / "out" / "step_3"), device="cpu")
    assert set(saved) == {"lora"}
    assert paths(saved) == paths(setup.trainer.state.params)
    for step in (2, 3):
        assert (tmp_path / "out" / "state" / f"step_{step}").exists()
    assert (tmp_path / "out" / "best").exists()

    rec2 = train_llm.main(llm_argv(tmp_path, mode, 4, "--resume"))
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "training done" in out
    assert rec2["resumed_from"] == 3 and rec2["step"] == 4
    assert [r["step"] for r in rec2["log"] if "loss" in r] == [4]


def test_train_llm_no_lora_trains_the_whole_tree(tmp_path):
    """--no-lora trains the whole model, as the script does; with
    --learnable-embeddings-only the text rows of embed_tokens and lm_head
    stay bit-identical while the image-token rows move."""
    write_shard(tmp_path / "data_000.tar", qa_records())
    args = train_llm.parse_args(
        ["--data", str(tmp_path / "data_*.tar"), "--mode", "sft",
         "--model", "tiny", "--no-lora", "--learnable-embeddings-only", "--old-vocab-size",
         "100", "--steps", "2", "--batch-size", "4", "--max-length", "48",
         "--save-steps", "2", "--warmup", "0", "--lr", "1e-2",
         "--output", str(tmp_path / "out"), "--device", "cpu"])
    setup = train_llm.build(args)
    assert setup.base is None
    before = fingerprint(setup.trainer.state.params)
    train_llm.run(args, setup)
    after = setup.trainer.state.params
    saved = restore_checkpoint(str(tmp_path / "out" / "step_2"), device="cpu")
    assert paths(saved) == paths(after) == paths(before)
    emb = after["embed_tokens"]["embedding"]
    old = before["embed_tokens/embedding"]
    assert torch.equal(emb[:100], old[:100])
    assert not torch.equal(emb[100:270], old[100:270])
    assert torch.equal(after["lm_head"]["kernel"][:, :100],
                       before["lm_head/kernel"][:, :100])
    assert not torch.equal(after["layers"][0]["q_proj"]["kernel"],
                           before["layers/0/q_proj/kernel"])


def test_train_llm_loss_matches_script(tmp_path):
    """The port's loss (adapters over the closed-over base) against
    scripts/train_llm.py's loss_fn on the same weights and batch: an SFT
    text batch within 1e-5; a pretrain batch whose image ids lie past
    TINY_LLAMA's vocabulary is NaN on both sides."""
    cfg = JM.TINY_LLAMA
    jbase = JM.init_llama(jax.random.PRNGKey(0), cfg, jnp.float32)
    jlora = JLORA.init_lora(jax.random.PRNGKey(1), jbase, r=4, alpha=8)
    jlora["adapters"] = {   # non-zero B: the adapters change the loss
        k: {"a": v["a"], "b": jnp.asarray(np.random.RandomState(i).randn(
            *v["b"].shape).astype(np.float32) * 0.02)}
        for i, (k, v) in enumerate(sorted(jlora["adapters"].items()))}
    tbase = bridge.from_seed_tpu(jax.tree.map(np.asarray, jbase), device="cpu")
    tlora = bridge.lora_from_seed_tpu(jax.tree.map(np.asarray, jlora),
                                      device="cpu")

    def script_loss_fn(p, batch, rng):       # scripts/train_llm.py:100-105
        merged = JLORA.apply_lora(p["base"], p["lora"])
        logits = JM.forward(merged, batch["input_ids"], cfg,
                            attn_mask=batch["attention_mask"], remat=True,
                            use_flash=True)
        return JLOSS.cross_entropy(logits[:, :-1], batch["labels"][:, 1:])

    port_loss = train_llm.llm_loss(train_llm.MODELS["tiny"], tbase, True)
    for mode, records in (("sft", qa_records()), ("pretrain",
                                                   caption_records())):
        write_shard(tmp_path / "data_000.tar", records)
        args = train_llm.parse_args(["--data", str(tmp_path / "data_*.tar"),
                                     "--mode", mode, "--batch-size", "4",
                                     "--max-length", "48"])
        batch = next(train_llm.batch_stream(args, train_llm.ByteTextTokenizer()))
        want = float(script_loss_fn({"base": jbase, "lora": jlora},
                                    {k: jnp.asarray(v) for k, v in batch.items()},
                                    None))
        got = float(port_loss({"lora": tlora},
                              {k: torch.from_numpy(v) for k, v in batch.items()},
                              None))
        if mode == "sft":
            assert np.isfinite(want)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            assert np.isnan(want) and np.isnan(got)


def test_train_llm_refuses_what_one_card_cannot_run(tmp_path):
    write_shard(tmp_path / "data_000.tar", qa_records(4))
    argv = ["--data", str(tmp_path / "data_*.tar"), "--output",
            str(tmp_path / "o"), "--device", "cpu"]
    # --tp 2 needs two ranks (tests/test_torch_parallel_train.py runs them)
    with pytest.raises(ValueError, match="torchrun"):
        train_llm.main(argv + ["--tp", "2"])
    with pytest.raises(ValueError, match="--no-lora"):
        train_llm.main(argv + ["--learnable-embeddings-only"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_llm.main(argv[:-2])


def test_best_checkpoint_follows_cider():
    """A fault of the reference that the port does not keep: the script
    reads ``scores.get("cider", scores.get("bleu4", 0.0))`` but the metrics
    are keyed "CIDEr" and "BLEU-4", so every score is 0.0 and only the
    first eval is ever the best. The port picks by CIDEr."""
    caps = ["a red fox", "two dogs on grass", "a boat at sea"]
    scores = caption_metrics([{"image_id": i, "caption": c}
                              for i, c in enumerate(caps)],
                             {i: [c] for i, c in enumerate(caps)})
    assert scores.get("cider", scores.get("bleu4", 0.0)) == 0.0
    assert scores[train_llm.EVAL_KEY] > 0.0


# ----------------------------------------------------------- tokenizer

def tok_argv(tmp_path, stage, out, steps=2, *extra):
    return ["--stage", str(stage), "--arch", "tiny",
            "--data", str(tmp_path / "img_*.tar"), "--steps", str(steps),
            "--batch-size", "4", "--save-steps", "2", "--warmup", "0",
            "--output", str(tmp_path / out), "--device", "cpu", *extra]


def seed_tpu_trees(stage):
    """The trees scripts/train_tokenizer.py builds at --arch tiny, in the
    port's layout (stacked blocks as lists)."""
    import dataclasses
    base = JST.TINY_TOKENIZER
    cfg = dataclasses.replace(
        base, vit=dataclasses.replace(base.vit, use_flash=True),
        qformer=dataclasses.replace(base.qformer, with_text=(stage == 1)),
        with_recon_blocks=(stage == 2), use_qformer_image=(stage == 2))
    key = jax.random.PRNGKey(42)
    tok = JST.init_seed_tokenizer(key, cfg)
    if stage == 1:
        s1 = JTT.Stage1Config(tokenizer=cfg)
        tree = {"tokenizer": tok,
                "head": JTT.init_stage1_head(jax.random.fold_in(key, 1), s1),
                "itm_head": JTT.init_itm_head(jax.random.fold_in(key, 3), s1),
                "lm_head": JQ.init_lm_head(jax.random.fold_in(key, 4),
                                           cfg.qformer)}
        pattern = JTT.STAGE1_TRAINABLE
    else:
        tree, pattern = tok, JTT.STAGE2_TRAINABLE
    port = lambda t: bridge.from_seed_tpu(jax.tree.map(np.asarray, t),
                                          device="cpu")
    return port(tree), port(j_filter_tree(tree, pattern))


def test_train_tokenizer_stage1_then_stage2(tmp_path, capsys):
    write_img_tar(tmp_path / "img_000.tar")
    # stage 1, with an eval round and a resume
    args = train_tokenizer.parse_args(tok_argv(
        tmp_path, 1, "s1", 2, "--eval-data", str(tmp_path / "img_*.tar"),
        "--eval-batches", "1"))
    setup = train_tokenizer.build(args)
    full, trainable = seed_tpu_trees(1)
    assert paths(setup.trainer.state.params) == paths(full)
    vit0 = fingerprint(setup.trainer.state.params["tokenizer"]["vit"])
    rec = train_tokenizer.run(args, setup)
    out = capsys.readouterr().out
    assert "training done" in out and "eval_loss" in out
    for r in rec["log"]:
        if "loss" in r:
            assert all(np.isfinite(r[k]) for k in ("loss", "itc", "itm", "lm"))
    vit = setup.trainer.state.params["tokenizer"]["vit"]
    assert all(torch.equal(x, vit0[p]) for p, x in leaves_with_path(vit))
    saved = restore_checkpoint(str(tmp_path / "s1" / "step_2"), device="cpu")
    assert paths(saved) == paths(trainable)
    assert all(re.search(STAGE1_TRAINABLE, p) for p in paths(saved))
    rec = train_tokenizer.main(tok_argv(tmp_path, 1, "s1", 3, "--resume"))
    assert rec["resumed_from"] == 2 and rec["step"] == 3
    assert "resumed from step 2" in capsys.readouterr().out

    # stage 2 from the stage-1 checkpoint, random CLIP targets
    args = train_tokenizer.parse_args(tok_argv(
        tmp_path, 2, "s2", 2, "--init-ckpt", str(tmp_path / "s1" / "step_2")))
    setup = train_tokenizer.build(args)
    params = setup.trainer.state.params
    full, trainable = seed_tpu_trees(2)
    assert paths(params) == paths(full)
    # the stage-1 Q-Former's query path is merged in (its text pathway has
    # no place in the stage-2 tree)
    have = dict(leaves_with_path(params["qformer"]))
    merged = [p for p, x in leaves_with_path(saved["tokenizer"]["qformer"])
              if p in have and torch.equal(have[p], x)]
    assert sorted(merged) == sorted(have)
    frozen0 = {p: x.clone() for p, x in leaves_with_path(params)
               if not re.search(STAGE2_TRAINABLE, p)}
    rec = train_tokenizer.run(args, setup)
    out = capsys.readouterr().out
    assert "WARNING: no --clip-ckpt" in out and "training done" in out
    for r in rec["log"]:
        if "loss" in r:
            assert 0 < r["codebook_usage"] <= 1
            assert all(np.isfinite(r[k]) for k in ("vq", "recon", "distill"))
    after = dict(leaves_with_path(setup.trainer.state.params))
    assert all(torch.equal(after[p], x) for p, x in frozen0.items())
    saved2 = restore_checkpoint(str(tmp_path / "s2" / "step_2"), device="cpu")
    assert paths(saved2) == paths(trainable)


def test_train_tokenizer_loss_matches_script(tmp_path):
    """Stage 2 (deterministic: no sampled negatives): the port's loss on a
    collated batch of its own stream against stage2_loss_scalar of
    seed_tpu on the same weights, within 1e-5."""
    write_img_tar(tmp_path / "img_000.tar")
    args = train_tokenizer.parse_args(tok_argv(tmp_path, 2, "o"))
    setup = train_tokenizer.build(args)
    import dataclasses
    jcfg = JTT.Stage2Config(tokenizer=dataclasses.replace(
        JST.TINY_TOKENIZER, with_recon_blocks=True, use_qformer_image=True))
    jp = JST.init_seed_tokenizer(jax.random.PRNGKey(3), jcfg.tokenizer)
    tp = bridge.from_seed_tpu(jax.tree.map(np.asarray, jp), device="cpu")
    collate = train_tokenizer.make_collate(args, setup,
                                           train_llm.ByteTextTokenizer())
    items = [next(train_tokenizer.example_stream(args)) for _ in range(1)] * 3
    batch = collate(items)
    got, _ = setup.loss_fn(tp, batch, None)
    want = JTT.stage2_loss_scalar(jp, {k: jnp.asarray(v.numpy())
                                       for k, v in batch.items()}, None, jcfg)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)


def test_new_modules_import_neither_jax_nor_seed_tpu():
    code = textwrap.dedent("""
        import sys
        import seed_tpu_torch.data, seed_tpu_torch.eval
        import seed_tpu_torch.train.train_llm, seed_tpu_torch.train.train_tokenizer
        import seed_tpu_torch.train.tokenizer_training
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "seed_tpu")]
        assert not bad, bad
        print("isolated")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "isolated"
