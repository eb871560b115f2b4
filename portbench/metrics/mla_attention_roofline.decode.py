"""The latent decode attention (``ops/attention.py``
``decode_latent_attention`` -> ``csrc/decode_attention.cu``
``decode_latent_kernel``): the least time of every call of the traced
requests (batch x (position + 1) cached rows once, the queries in, the
output out, over the HBM rate; or its operations over the bf16 peak; the
family's ``latent_call``) over their summed device time."""

from portbench import costs, expect
from portbench.families import family

KERNEL = r"decode_latent_kernel"


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    want = expect.decode(run).get("latent", [])
    got = run.trace.kernels(KERNEL)
    if not expect.matches("mla_attention_roofline.decode", want, got):
        return None
    fam = family(run.dims.family)
    need = sum(costs.least_time(*fam.latent_call(run.dims, batch, keys), run.peaks)
               for batch, keys in want)
    return 100.0 * need / expect.seconds(got)
