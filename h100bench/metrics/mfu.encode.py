"""mfu.encode (%), layer "encode": the operations of the images encoded in
the window (``core/work.seed_encode_flops``: EVA-ViT, Q-Former,
encode_task, VQ distances) over the encode calls' synchronised time
(``preprocess`` -> ``seed_tokenizer.encode`` -> ids on the host) at the
bf16 peak of 989 TFLOP/s. Calls inside the profiled slice are left out."""
from h100bench.core.peaks import BF16_FLOPS
from h100bench.core.work import seed_encode_flops


def read(run):
    prof = set(map(id, run.in_profile("encode")))
    spans = [s for s in run.in_window("encode") if id(s) not in prof]
    took = sum(s.seconds for s in spans)
    if not took:
        return None
    images = sum(s.info["images"] for s in spans)
    return 100.0 * images * seed_encode_flops(run.cell.spec) / (took * BF16_FLOPS)
