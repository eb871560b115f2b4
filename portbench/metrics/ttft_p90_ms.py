"""The 90th percentile over all requests of the window of the time from a
request's issue to its first token: CUDA events recorded at the issue and
after the prefill, on the device's clock, with no host sync added to the
path (linear interpolation between order statistics)."""

import statistics


def read(run):
    ttft = [r["ttft_ms"] for r in run.requests]
    if len(ttft) < 2:
        return None
    return statistics.quantiles(ttft, n=10, method="inclusive")[8]
