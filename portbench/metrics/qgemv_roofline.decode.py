"""K5 (``ops/qmm.py`` ``qgemv`` -> ``csrc/qmm.cu`` ``qgemv_mma_kernel``) at
decode: the least time of every K5 call of the traced requests (its bytes
over the HBM rate, each input byte once) over their summed device time."""

from portbench import costs, expect

KERNEL = r"qgemv_mma_kernel<\d+, *false"


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    want = expect.decode(run)["qgemv"]
    got = run.trace.kernels(KERNEL)
    if not expect.matches("qgemv_roofline.decode", want, got):
        return None
    need = sum(costs.least_time(*costs.qgemv_call(*call), run.peaks) for call in want)
    return 100.0 * need / expect.seconds(got)
