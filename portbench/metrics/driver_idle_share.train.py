"""Share of the traced window (whole WCT steps) in which the device was idle
while the host was innermost in a driver span (``qeft.finetune.*``: loss,
backward, optimizer)."""

from portbench import programspans


def read(run):
    return programspans.idle_share(run.trace, "drivers")
