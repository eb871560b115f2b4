"""K2 (``ops/qmm.py`` ``qgemm`` -> ``csrc/qmm.cu`` ``qmm_gemm_kernel<false,
...>`` and its split-K sum ``qgemm_reduce_kernel``) in the prefills of the
traced requests: the larger of operations over the bf16 peak and bytes over
the HBM rate, over the trace's K2 time."""

from portbench import costs, expect

KERNEL = r"qmm_gemm_kernel<false"
SUM = r"qgemm_reduce_kernel"


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    want = expect.decode(run)["qgemm"]
    got = run.trace.kernels(KERNEL)
    if not expect.matches("qgemm_roofline.prefill", want, got):
        return None
    need = sum(costs.least_time(*costs.qgemm_call(m, k, n, g, r), run.peaks)
               for m, k, n, g, r, _ in want)
    return 100.0 * need / expect.seconds(got + run.trace.kernels(SUM))
