"""The port's own spans over the profiled slice, for the ``device_ms.*``
readers and ``idle_outside_program.tok``.

The program records a span at each layer boundary of the encode path
(``seed_tpu_torch.utils.metrics_logging.span``) while a profiler records,
that is, in the traced slice only. Each span holds its host interval on
``time.time_ns()``, the clock of the profiler's events, and its device
interval between two CUDA events. A span is taken when its host interval
lies inside the slice: from the first to the last of the profile's device
operations and benchmark span marks. A program without spans records
nothing, and every reader then returns None.

The split is a partition of the device time of the slice's ``preprocess``
and ``tokenizer.encode`` spans: each span's device self time (its time less
its children's) goes to one part, by the spans above it:

- ``preprocess``: the ``preprocess`` span;
- ``qformer``: ``qformer`` and everything under it;
- ``vit.<part>``: under ``vit``, the outermost ``linear``, ``attention``,
  ``layer_norm`` or ``act`` span and everything under it;
- ``vit.self``: ``vit``'s own self time (residual adds, EVA's q/v bias,
  patchify, class token and positions);
- ``encode.rest``: the rest of ``tokenizer.encode`` (``ln_vision``,
  ``encode_task``, the VQ distances and argmin).
"""
from collections import defaultdict

ROOTS = ("preprocess", "tokenizer.encode")
VIT_PARTS = ("linear", "attention", "layer_norm", "act")


def program_spans(run):
    """The program's span records inside the profiled slice (a list, maybe
    empty), or None where the program has no span records."""
    try:
        from seed_tpu_torch.utils.metrics_logging import recorded_spans
    except ImportError:
        return None
    p = run.profile
    edges = [t for o in p.ops for t in (o.start_ns, o.start_ns + o.dur_ns)]
    edges += [t for _, a, b in p.marks for t in (a, b)]
    lo, hi = min(edges), max(edges)
    return [r for r in recorded_spans() if lo <= r.start_ns
            and r.end_ns <= hi]


def part(rec, by_id) -> str:
    """The part of the split a span's self time goes to, or None outside
    the encode path."""
    names = []                      # the span, then the spans above it
    while rec is not None:
        names.append(rec.name)
        rec = by_id.get(rec.parent_id)
    if names[-1] not in ROOTS:
        return None
    if names[-1] == "preprocess":
        return "preprocess"
    if "qformer" in names:
        return "qformer"
    if "vit" in names:
        below = names[:names.index("vit")]
        outer = [n for n in below if n in VIT_PARTS]
        return "vit." + outer[-1] if outer else "vit.self"
    return "encode.rest"


def split(run):
    """{part: device ms an image} over the slice's encode calls, or None
    where there is nothing to read (no spans, no images, no device times)."""
    recs = program_spans(run)
    if not recs:
        return None
    images = sum(r.counts.get("images", 0) for r in recs
                 if r.name == "tokenizer.encode")
    if not images:
        return None
    by_id = {r.span_id: r for r in recs}
    ms = defaultdict(float)
    for r in recs:
        name = part(r, by_id)
        if name is not None and r.device_self_ms is not None:
            ms[name] += r.device_self_ms
    return {k: v / images for k, v in ms.items()} or None


def device_ms(run, name: str):
    parts = split(run)
    return None if parts is None else parts.get(name)
