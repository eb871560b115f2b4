"""Share of the traced window (whole WCT steps) in which the device was idle
while the host was innermost in a model span (``qeft.model.*``: embedding,
block, attention, head)."""

from portbench import programspans


def read(run):
    return programspans.idle_share(run.trace, "model")
