"""K7 (``ops/qmm.py`` ``qgemm_t`` -> ``csrc/qmm.cu`` ``qmm_gemm_kernel<true,
...>``), ``dx`` of the traced WCT steps: the larger of operations over the
bf16 peak and bytes over the HBM rate, over the trace's K7 time."""

from portbench import costs, expect

KERNEL = r"qmm_gemm_kernel<true"


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    want = expect.train(run)["qgemm_t"]
    got = run.trace.kernels(KERNEL)
    if not expect.matches("qgemm_t_roofline.train", want, got):
        return None
    need = sum(costs.least_time(*costs.qgemm_t_call(m, k, n, g, r), run.peaks)
               for m, k, n, g, r, _ in want)
    return 100.0 * need / expect.seconds(got)
