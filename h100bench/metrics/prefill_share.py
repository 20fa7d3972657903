"""prefill_share (%), layer "scheduler": the share of the window's wall time
spent inside prefill calls of the continuous batcher (``_prefill``,
``_prefill_at``, ``_install_prefill``; synchronised spans). A prefill
stalls every live slot's decode, so it moves tpot_p95_ms."""


def read(run):
    spans = run.in_window("prefill")
    if not spans:
        return None
    a, b = run.window
    return 100.0 * sum(s.seconds for s in spans) / (b - a)
