"""Share of the traced window (whole requests: prefill and decode) in which the
device was idle while the host was innermost in a driver span
(``qeft.generate.*``: prefill, first step, capture, replay, wait)."""

from portbench import programspans


def read(run):
    return programspans.idle_share(run.trace, "drivers")
