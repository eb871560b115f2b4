"""The program's own spans in a reduced `Trace`: the device's idle time split
by the layer the host was in, and the decode loop's fixed cost a request.

``qeft_tpu_torch`` names its stretches ``qeft.<layer>.<what>``
(``qeft_tpu_torch.utils.profiling.span``): ``qeft.generate.*`` and
``qeft.finetune.*`` are the drivers, ``qeft.model.*`` the model and
``qeft.linear.*`` the packed linear.  They are CPU events of the profiler
session that records the device, so they share its clock, and `Trace.host`
holds them.  A program without them (an older one) gives None from every
function here, never 0.

`idle_split` rebuilds the traced window as ``trace.reduce`` does (from the
first indexed benchmark span to the latest end of an indexed span or an
indexed activity) and charges every idle nanosecond of it to the innermost
program span open on the host then: the shortest over all threads, since
autograd's backward runs on a thread of its own.  Idle time under no program
span is ``outside``; other CPU events choose nothing.  The layers and
``outside`` add up to the window's idle time, which ``idle_share.*`` reads."""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

from portbench.trace import SPAN, Trace

PREFIX = "qeft."
LAYERS = {"generate": "drivers", "finetune": "drivers", "model": "model", "linear": "linear"}
LOOP_SETUP = ("qeft.generate.first_step", "qeft.generate.capture")


def layer_of(name: str) -> Optional[str]:
    """The layer of a program span's name, or None for any other event."""
    if not name.startswith(PREFIX):
        return None
    return LAYERS.get(name[len(PREFIX):].split(".", 1)[0])


def _indexed(name: str) -> bool:
    return name.startswith(SPAN) and "#" in name[len(SPAN):]


def window(tr: Trace) -> Optional[Tuple[int, int]]:
    """(start, end) in ns of the traced window, as ``trace.reduce`` sets it."""
    outer = [(s, t) for s, t, name in tr.host if _indexed(name)]
    if outer:
        return (min(s for s, _ in outer),
                max([t for _, t in outer] + [a.end for a in tr.activities if a.index is not None]))
    if tr.activities:
        return tr.activities[0].start, max(a.end for a in tr.activities)
    return None


def idle_intervals(tr: Trace, w0: int, w1: int) -> List[Tuple[int, int]]:
    """The stretches of [w0, w1) in which no device activity ran, in order."""
    out, cur = [], w0
    for a in tr.activities:  # by start
        s, t = max(a.start, w0), min(a.end, w1)
        if t <= s:
            continue
        if s > cur:
            out.append((cur, s))
        cur = max(cur, t)
    if cur < w1:
        out.append((cur, w1))
    return out


def idle_split(tr: Optional[Trace]) -> Optional[Dict]:
    """{"window": ns, "idle": {layer: ns, ..., "outside": ns}, "spans": {span
    name: ns}, "layers": the layers with a span in the window}, or None when
    the window is empty, the device never ran or no program span lies in the
    window."""
    if tr is None or tr.window_ns <= 0 or not tr.busy_ns:
        return None
    win = window(tr)
    if win is None:
        return None
    w0, w1 = win
    spans = sorted((max(s, w0), min(t, w1), t - s, name) for s, t, name in tr.host
                   if layer_of(name) is not None and s < w1 and t > w0)
    if not spans:
        return None
    idle = idle_intervals(tr, w0, w1)
    by_span = dict.fromkeys(sorted({name for _, _, _, name in spans}), 0)
    bounds = sorted({w0, w1}.union(*((s, t) for s, t, _, _ in spans)))
    open_spans: List = []  # (duration, -start, end, name): the top is the innermost
    i = j = 0
    for x, y in zip(bounds, bounds[1:]):
        while i < len(spans) and spans[i][0] <= x:
            s, t, dur, name = spans[i]
            heapq.heappush(open_spans, (dur, -s, t, name))
            i += 1
        while open_spans and open_spans[0][2] <= x:
            heapq.heappop(open_spans)
        while j < len(idle) and idle[j][1] <= x:
            j += 1
        if not open_spans:
            continue
        over, k = 0, j
        while k < len(idle) and idle[k][0] < y:
            over += min(y, idle[k][1]) - max(x, idle[k][0])
            k += 1
        by_span[open_spans[0][3]] += over
    charged = dict.fromkeys(sorted(set(LAYERS.values())), 0)
    for name, ns in by_span.items():
        charged[layer_of(name)] += ns
    charged["outside"] = sum(t - s for s, t in idle) - sum(charged.values())
    return {"window": w1 - w0, "idle": charged, "spans": by_span,
            "layers": {layer_of(name) for name in by_span}}


def idle_share(tr: Optional[Trace], layer: str) -> Optional[float]:
    """% of the traced window idle under a span of ``layer`` ("drivers",
    "model" or "linear"); None when the window holds none of its spans."""
    split = idle_split(tr)
    if split is None or layer not in split["layers"]:
        return None
    return 100.0 * split["idle"][layer] / split["window"]


def loop_setup_ms(tr: Optional[Trace]) -> Optional[float]:
    """Mean over the traced requests of each one's ``qeft.generate.first_step``
    and ``qeft.generate.capture`` durations, in ms: the decode loop's fixed
    cost a request.  None when the trace holds neither span."""
    if tr is None:
        return None
    requests = [(s, t) for s, t, name in tr.host if name.startswith(SPAN + "request#")]
    parts = [(s, t) for s, t, name in tr.host if name in LOOP_SETUP]
    if not requests or not parts:
        return None
    per = [sum(t1 - s1 for s1, t1 in parts if s <= s1 and t1 <= t) for s, t in requests]
    return sum(per) / len(per) / 1e6
