"""The grouped expert matvec (``ops/qmm.py`` ``qgemv_moe`` -> ``csrc/qmm.cu``
``qgemv_moe_kernel``) at decode: the least time of every call of the traced
requests (the experts its tokens are expected to touch under uniform
routing, each read once, and the rows in and out, over the HBM rate; the
family's ``moe_call``) over their summed device time."""

from portbench import costs, expect
from portbench.families import family

KERNEL = r"qgemv_moe_kernel"


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    want = expect.decode(run).get("moe", [])
    got = run.trace.kernels(KERNEL)
    if not expect.matches("moe_qgemv_roofline.decode", want, got):
        return None
    fam = family(run.dims.family)
    need = sum(costs.least_time(*fam.moe_call(run.dims, tokens, name), run.peaks)
               for tokens, name in want)
    return 100.0 * need / expect.seconds(got)
