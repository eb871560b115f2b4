"""Every token the window generated over the window's time (host clock, from
the first request's issue to the last one's return: prefill, graph capture
and host time all count)."""


def read(run):
    if not run.requests or run.window_s <= 0:
        return None
    return sum(r["batch"] * r["output"] for r in run.requests) / run.window_s
