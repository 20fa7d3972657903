"""unet_attention_roofline (%), layer "kernels": the UNet's self-attention
against its roofline over the profiled slice. The work is that of every
``self_attention`` span's contents, whatever runs them: the q, k, v and
out projections and 4 B H S^2 D of Q K^T and P V, at 989 TFLOP/s, or its
input, weights and output once each at 3.35 TB/s, whichever is longer, each
span bounded apart (``core/work_unclip.self_attention_work``; 16 spans a
pass, five of them over 9,216 tokens). The time is the device time of the
operations launched inside those spans (``_detok_split``). The program's
spans record only in a traced run; a program without them reads None."""
from h100bench.core.work_unclip import unet_self_attention_bound_s
from h100bench.metrics._detok_split import program_spans, split


def read(run):
    parts = split(run)
    if not parts or not parts.get("unet.self_attention"):
        return None
    recs = program_spans(run)
    passes = sum(1 for r in recs if r.name == "unet")
    images = sum(r.counts.get("images", 0) for r in recs
                 if r.name == "unclip.generate")
    # each pass runs the CFG batch: two rows an image
    need = passes * unet_self_attention_bound_s(run.cell.spec,
                                                2 * run.cell.batch)
    took = parts["unet.self_attention"] * images / 1e3
    return 100.0 * need / took
