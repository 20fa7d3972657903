"""launches_per_unet_pass (launches/pass), layer "host launches": the
device operations (kernels, copies, memsets) of the profiled de-tokenize
call, the decode half and the VAE included, over the UNet passes it ran
(the program's ``unet`` spans); a count that repeats exactly from run to
run. A program without the spans reads None."""
from h100bench.metrics._encode_split import program_spans


def read(run):
    recs = program_spans(run)
    passes = sum(1 for r in recs or () if r.name == "unet")
    if not passes:
        return None
    return len(run.profile.ops) / passes
