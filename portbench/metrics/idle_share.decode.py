"""Share of the traced window (whole requests: prefill and decode) in which
no device activity ran."""


def read(run):
    if run.trace is None or run.trace.window_ns <= 0 or not run.trace.busy_ns:
        return None
    return 100.0 * (1 - run.trace.busy_ns / run.trace.window_ns)
