"""prefill_ms_per_ktok (ms/ktok), layer "model step": synchronised time
inside prefill calls (``slot_prefill``, ``slot_prefill_at``,
``install_and_prefill_at``) per 1,000 real prompt tokens (bucket padding
not counted), in the window."""


def read(run):
    spans = run.in_window("prefill")
    tokens = sum(s.info["n"] for s in spans)
    if not tokens:
        return None
    return 1e3 * sum(s.seconds for s in spans) / (tokens / 1e3)
