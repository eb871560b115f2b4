"""Share of the traced requests whose decode loop reused a captured step:
of the traced ``request#`` spans, the share (%) that hold no
``qeft.generate.capture`` span.  A request that captures opens that span
on the host inside its own; one that replays a kept step opens none.  A
trace without request spans, or without any ``qeft.generate.`` span (a
program that does not name its decode loop), gives nothing."""

from portbench.trace import SPAN

CAPTURE = "qeft.generate.capture"


def read(run):
    tr = run.trace
    if tr is None:
        return None
    requests = [(s, t) for s, t, name in tr.host if name.startswith(SPAN + "request#")]
    if not requests or not any(name.startswith("qeft.generate.") for _, _, name in tr.host):
        return None
    captures = [s for s, _, name in tr.host if name == CAPTURE]
    reused = sum(not any(s <= c <= t for c in captures) for s, t in requests)
    return 100.0 * reused / len(requests)
