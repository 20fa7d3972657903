"""idle_outside_program.tok (%), layer "device": the share of the profiled
slice that the device spends outside the program's calls: the slice less
the device time of the program's outermost spans (``preprocess`` and
``tokenizer.encode``, between their CUDA events), over the slice's length,
``idle_share.tok``'s. It holds the caller's loop, the read-back and the
glue between calls; the rest of ``idle_share.tok`` is idle time inside the
program's device work (gaps between its kernels), whether or not the host
was still inside the program. Host intervals do not tell the two apart:
the host leaves ``tokenizer.encode`` long before the device has run it."""
from h100bench.metrics._encode_split import program_spans


def read(run):
    roots = [r for r in program_spans(run) or ()
             if r.parent_id is None and r.device_ms is not None]
    if not roots:
        return None
    inside_s = sum(r.device_ms for r in roots) / 1e3
    return 100.0 * (1.0 - inside_s / run.profile.window_s)
