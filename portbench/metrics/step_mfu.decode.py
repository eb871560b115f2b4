"""One decode step (``generate.DecodeLoop``, graph replays) against the
card: the least time of the traced requests' decode steps (the larger of
operations over the bf16 peak and bytes over the HBM rate; bytes: weights,
slabs, scales, biases, the head and K/V up to the position) over the time
their decode took on the device's clock, from the end of each prefill to
the end of the request's last activity (the first eager step, the capture
and the host's gaps included)."""

import collections

from portbench import costs, expect


def read(run):
    tr = run.trace
    if tr is None or run.peaks is None:
        return None
    by_req = collections.defaultdict(list)
    for a in tr.activities:
        if a.index is not None:
            by_req[a.index].append(a)
    if len(by_req) != len(run.traced["requests"]):
        return None
    spent = 0
    for acts in by_req.values():
        pre = [a.end for a in acts if a.span == "prefill"]
        if not pre:
            return None
        spent += max(a.end for a in acts) - max(pre)
    need = sum(costs.least_time(*costs.decode_step(run.dims, *step), run.peaks)
               for step in expect.decode(run)["steps"])
    return 100.0 * need / (spent / 1e9) if spent > 0 else None
