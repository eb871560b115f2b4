"""Share of the traced window (whole requests: prefill and decode) in which the
device was idle while the host was innermost in a model span
(``qeft.model.*``: embedding, block, attention, head)."""

from portbench import programspans


def read(run):
    return programspans.idle_share(run.trace, "model")
