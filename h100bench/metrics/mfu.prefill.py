"""mfu.prefill (%), layer "model step": the model operations of the real
prompt tokens prefilled in the window (``core/work.llama_prefill_flops``:
projections, causal attention, the chunk's one lm_head row) over the
prefill calls' synchronised time at the bf16 peak of 989 TFLOP/s."""
from h100bench.core.peaks import BF16_FLOPS
from h100bench.core.work import llama_prefill_flops


def read(run):
    spans = run.in_window("prefill")
    took = sum(s.seconds for s in spans)
    if not took:
        return None
    flops = sum(llama_prefill_flops(run.cell.spec, s.info["start"],
                                    s.info["n"]) for s in spans)
    return 100.0 * flops / (took * BF16_FLOPS)
