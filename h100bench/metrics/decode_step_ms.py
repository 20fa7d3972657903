"""decode_step_ms (ms), layer "model step": synchronised time inside the
batcher's decode calls (``slot_decode_sample_steps``, ``slot_decode_sample``,
``slot_decode``) over the decode steps they ran, in the window."""


def read(run):
    spans = run.in_window("decode")
    steps = sum(s.info["steps"] for s in spans)
    if not steps:
        return None
    return 1e3 * sum(s.seconds for s in spans) / steps
