"""Command lines of seed_tpu_torch named after the ``scripts/`` files of
seed_tpu they port, each run as ``python3 -m seed_tpu_torch.scripts.<name>``:

- ``merge_lora``               — merge LoRA adapters into the base, for export
- ``seed_tokenizer_inference`` — one image -> 32 ids -> unCLIP embedding ->
  pixels
- ``seed_llama_inference``     — the three canonical SEED-LLaMA prompts
- ``acceptance``               — the real-weight runbook: one pass / fail
  JSON report
- ``check_full_geometry``      — per-rank bytes of the sharded 8B / 14B
  training state, with no allocation

Each takes every flag of its script plus ``--device`` (the card unless
``--device cpu``) and is ``main(argv=None)`` over functions a caller can use
on its own.
"""
