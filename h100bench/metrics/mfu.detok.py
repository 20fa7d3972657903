"""mfu.detok (%), layer "model step": the operations of the images
de-tokenized in the window (``core/work_unclip.detok_flops``: the
tokenizer's decode half, each step's UNet pass over the CFG batch of two,
the VAE decoder) over the calls' synchronised time (codes ->
``decode_image`` -> float32 pixels on the host) at the bf16 peak of 989
TFLOP/s. Calls inside the profiled slice are left out."""
from h100bench.core.peaks import BF16_FLOPS
from h100bench.core.work_unclip import detok_flops


def read(run):
    prof = set(map(id, run.in_profile("decode")))
    spans = [s for s in run.in_window("decode") if id(s) not in prof]
    took = sum(s.seconds for s in spans)
    if not took:
        return None
    images = sum(s.info["images"] for s in spans)
    return 100.0 * images * detok_flops(run.cell.spec) / (took * BF16_FLOPS)
