"""idle_share.llm (%), layer "device": 1 - the union of the intervals in
which any device operation ran, over the profiled slice of an LLM cell's
window (the traffic file's ``profile``), on the host's synchronised clock."""


def read(run):
    p = run.profile
    return 100.0 * (1.0 - p.busy_s() / p.window_s)
