"""launches_per_image (launches/image), layer "host launches": the device
operations (kernels, copies, memsets) of the profiled encode calls over the
images they encoded; a count that repeats exactly from run to run."""


def read(run):
    images = sum(s.info["images"] for s in run.in_profile("encode"))
    if not images:
        return None
    return len(run.profile.ops) / images
