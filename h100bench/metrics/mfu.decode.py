"""mfu.decode (%), layer "model step": the least time the window's decode
steps need over the time they took. A step's least time is the larger of its
operations at the bf16 peak and its compulsory bytes at the HBM peak
(``core/work.llama_decode_work``: the stored weights once, each live slot's
cache rows once, the new k and v once); summed over every step of every
decode call in the window, over the calls' synchronised time."""
from h100bench.core.work import bound_s, llama_decode_work


def read(run):
    spans = run.in_window("decode")
    need, took = 0.0, 0.0
    for s in spans:
        for t in range(s.info["steps"]):
            f, b = llama_decode_work(run.cell.spec,
                                     [c + t for c in s.info["ctx"]],
                                     run.cell.cache_bytes)
            need += bound_s(f, b)
        took += s.seconds
    if not took:
        return None
    return 100.0 * need / took
