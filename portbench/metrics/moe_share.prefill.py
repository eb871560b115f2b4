"""The expert layer's share of the prefills' kernel time: of the device
time of the kernels each traced prefill launched, the share launched while
the program's ``qeft.model.moe`` span was open on the host.

A prefill runs on one stream after the previous request has been waited
for, so its kernels are the first ones to start on the device after its
span opened, in the order the host launched them: the k-th kernel launch
call in the span (a runtime or driver call whose name holds
``LaunchKernel``) is the k-th kernel (not a copy or a fill) to start after
the span's start.  A trace without the program's span gives nothing."""

import re
import sys

from portbench.trace import SPAN

MOE = "qeft.model.moe"
LAUNCH = re.compile(r"LaunchKernel")


def read(run):
    tr = run.trace
    if tr is None:
        return None
    prefills = sorted((s, t) for s, t, name in tr.host if name == SPAN + "prefill")
    moe = [(s, t) for s, t, name in tr.host if name == MOE]
    if not prefills or not moe:
        return None
    kernels = [a for a in tr.activities if not a.name.startswith(("Memcpy", "Memset"))]
    total = inside = 0
    for s, t in prefills:
        launches = sorted(h0 for h0, _, name in tr.host if s <= h0 <= t and LAUNCH.search(name))
        ran = [a for a in kernels if a.start >= s][:len(launches)]  # activities are by start
        if len(ran) < len(launches):
            print(f"moe_share.prefill: {len(launches)} kernel launches, {len(ran)} kernels "
                  "after a prefill began: left out", file=sys.stderr)
            return None
        total += sum(a.end - a.start for a in ran)
        inside += sum(a.end - a.start for a, at in zip(ran, launches)
                      if any(ms <= at <= mt for ms, mt in moe))
    return 100.0 * inside / total if total else None
