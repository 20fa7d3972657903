"""The port's own spans over the profiled de-tokenize, for the nine
``device_ms.*`` readers of the ``unclip`` kind and
``unet_attention_roofline``.

The program records its spans while a profiler records, that is in the
traced slice only (``_encode_split.program_spans`` takes those inside it).
Under the profiler the de-tokenize's host runs behind its device (about
2,700 launches a UNet pass, each recorded), so a span's CUDA events would
time idle gaps too. The split therefore gives each device operation of the
slice (kernel, copy, memset) to the innermost program span open on the host
when the operation was launched: the profiler links each device operation to
the host op that launched it (``linked_correlation_id``), and host op and
span share the clock. A part's time is the sum of its operations' device
durations, so the parts add up to the device's busy time inside the roots.

The split is a partition of the device operations launched inside the
slice's ``tokenizer.decode_embedding`` and ``unclip.generate`` spans, by
the spans above the launching one:

- ``detok.embed``: ``tokenizer.decode_embedding`` and everything under it
  (codebook rows, ``decode_task``, four ViT blocks, ``image_down``,
  ``distill_image_proj``);
- ``vae``: ``vae`` and everything under it;
- under ``unet``: ``unet.self_attention``, ``unet.cross_attention`` and
  ``unet.ff``, each span of that name with everything under it;
  ``unet.group_norm``, every other ``group_norm`` (the resnets', the
  transformers' and the output's); ``unet.resnet``, the rest of each
  ``resnet`` (its convolutions, time projection, SiLU and adds);
  ``unet.rest``, ``unet``'s own operations and its other children (conv in /
  out, down- and upsampling convolutions, the time and class embeddings,
  proj in / out, LayerNorms, the skip concatenations, residual adds);
- ``detok.rest``: the rest of ``unclip.generate`` (the embedding's noise,
  the CFG batch, the DDIM steps and guidance, the clamp, the pixels' copy
  to the host).

The raw profile comes from the cell (``run.cell.profiled``, kept by
``models/unclip.py`` when it stops the profiler). A program without these
spans records nothing, and every reader then returns None.
"""
from collections import defaultdict

from h100bench.metrics._encode_split import program_spans

ROOTS = ("tokenizer.decode_embedding", "unclip.generate")
UNET_BLOCKS = ("self_attention", "cross_attention", "ff")
PARTS = ("detok.embed", "unet.self_attention", "unet.cross_attention",
         "unet.ff", "unet.group_norm", "unet.resnet", "unet.rest", "vae",
         "detok.rest")


def part(rec, by_id):
    """The part of the split a span's self time goes to, or None outside
    the de-tokenize."""
    names = []                      # the span, then the spans above it
    while rec is not None:
        names.append(rec.name)
        rec = by_id.get(rec.parent_id)
    if names[-1] not in ROOTS:
        return None
    if names[-1] == "tokenizer.decode_embedding":
        return "detok.embed"
    if "vae" in names:
        return "vae"
    if "unet" not in names:
        return "detok.rest"
    below = names[:names.index("unet")]
    for name in reversed(below):            # the outermost first
        if name in UNET_BLOCKS:
            return "unet." + name
    for name in ("group_norm", "resnet"):
        if name in below:
            return "unet." + name
    return "unet.rest"


def launches(prof):
    """(host launch ns, device ns) of each device operation of a raw
    profile that the profiler links to the host op that launched it."""
    from torch.autograd import DeviceType
    from h100bench.core.trace import Tracer, _is_device_op, _ns
    start, ops = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            dur = _ns(e, "duration")
            if dur > 0 and _is_device_op(e, Tracer.PREFIX):
                ops.append((e.linked_correlation_id(), dur))
        elif e.linked_correlation_id() == 0:
            start[e.correlation_id()] = _ns(e, "start")
    return sorted((start[c], d) for c, d in ops if c in start)


def innermost(recs, times):
    """The innermost span record open at each of the sorted host ``times``
    (None outside every span); spans of one thread nest."""
    recs = sorted(recs, key=lambda r: (r.start_ns, -r.end_ns))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(recs) and recs[i].start_ns <= t:
            while stack and stack[-1].end_ns < recs[i].start_ns:
                stack.pop()
            stack.append(recs[i])
            i += 1
        while stack and stack[-1].end_ns < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def split(run):
    """{part: device ms an image} over the slice's de-tokenize calls, or None
    where there is nothing to read (no spans, no images, no raw profile).
    Read once a run: every reader gets the same ``run``."""
    if not hasattr(run, "detok_split"):
        run.detok_split = _split(run)
    return run.detok_split


def _split(run):
    recs = program_spans(run)
    prof = getattr(run.cell, "profiled", None)
    if not recs or prof is None:
        return None
    images = sum(r.counts.get("images", 0) for r in recs
                 if r.name == "unclip.generate")
    if not images:
        return None
    by_id = {r.span_id: r for r in recs}
    ops = launches(prof)
    ms = defaultdict(float)
    for (_, dur), rec in zip(ops, innermost(recs, [t for t, _ in ops])):
        name = None if rec is None else part(rec, by_id)
        if name is not None:
            ms[name] += dur / 1e6
    return {k: v / images for k, v in ms.items()} or None


def device_ms(run, name: str):
    parts = split(run)
    return None if parts is None else parts.get(name)
