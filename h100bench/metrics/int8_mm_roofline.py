"""int8_mm_roofline (%), layer "kernels": the int8 kernel's share of its
roofline (``ops/int8_matmul``, ``csrc/int8_matmul.cu``; kernel row 2) over
the profiled slice. The work is that of every int8 linear the slice's
prefill calls ran at M >= 256 with K and N multiples of 128 (the port's
dispatch rule): 2 M N K at 989 TFLOP/s or x, the int8 weight, the scale and
y once each at 3.35 TB/s, whichever is longer
(``core/work.int8_linear_work``). The time is the device time of the
kernels named below, the split-K reduction included. The profiled slice is
the traffic file's ``profile``."""
from h100bench.core.work import bound_s, int8_linear_work, llama_linears

KERNELS = ("int8_mm_bf16", "int8_mm_reduce")


def _kernel(k: int, n: int, m: int) -> bool:
    return m >= 256 and k % 128 == 0 and n % 128 == 0


def read(run):
    spec = run.cell.spec
    need = 0.0
    for s in run.in_profile("prefill"):
        m = s.info["m"]
        for k, n in llama_linears(spec):
            if _kernel(k, n, m):
                need += spec.layers * bound_s(*int8_linear_work(m, k, n))
    took = run.profile.device_seconds(lambda name: any(k in name
                                                       for k in KERNELS))
    if not need or not took:
        return None
    return 100.0 * need / took
