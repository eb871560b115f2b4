"""The decode loop's fixed cost a request: the mean, over the traced
requests, of each one's first eager step and capture of the step
(``qeft.generate.first_step`` + ``qeft.generate.capture``), host time on
the device trace's clock."""

from portbench import programspans


def read(run):
    return programspans.loop_setup_ms(run.trace)
