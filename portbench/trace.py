"""The device trace of a bounded stretch of a run, and its reduction.

`Tracer` records one stretch with ``torch.profiler``'s Kineto back end (CPU
ops, the benchmark's own spans and every device activity) and hands the raw
events over without building the profiler's Python tables.  `reduce`
turns them into a `Trace`: the device activities in time order, each tagged
with the benchmark span it belongs to (the span that enclosed its launch,
found by correlation, else the span that encloses it in time), the busy and
window times, the top device operations and the idle gaps by what the host
was doing.  Per-layer metrics read a `Trace` (``metrics/*.py``)."""

from __future__ import annotations

import bisect
import collections
import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import torch

SPAN = "portbench."  # the prefix of every span the benchmark records


@dataclasses.dataclass
class Activity:
    name: str
    start: int  # ns
    end: int
    span: Optional[str]  # the innermost benchmark span ("prefill", "request", "step", ...)
    index: Optional[int]  # the request or step index of the enclosing outer span


@dataclasses.dataclass
class Trace:
    activities: List[Activity]
    window_ns: int
    busy_ns: int
    host: List[Tuple[int, int, str]]  # CPU events (start, end, name), by start
    notes: List[str] = dataclasses.field(default_factory=list)

    def kernels(self, pattern: str, span: Optional[str] = None) -> List[Activity]:
        rx = re.compile(pattern)
        return [a for a in self.activities
                if rx.search(a.name) and (span is None or a.span == span)]


def span(name: str, index: Optional[int] = None):
    """A benchmark span around a call into the program (a ``record_function``
    range; free when no profiler runs)."""
    label = SPAN + name + ("" if index is None else f"#{index}")
    return torch.profiler.record_function(label)


class Tracer:
    """``start()`` ... ``stop()`` around the traced stretch; ``stop`` returns
    the raw Kineto result."""

    def __init__(self):
        from torch.autograd import (ProfilerConfig, ProfilerState, _prepare_profiler)
        from torch.profiler import ProfilerActivity

        self.acts = {ProfilerActivity.CPU, ProfilerActivity.CUDA}
        self.cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                                  torch._C._profiler._ExperimentalConfig())
        _prepare_profiler(self.cfg, self.acts)

    def start(self) -> None:
        from torch.autograd import _enable_profiler

        torch.cuda.synchronize()
        _enable_profiler(self.cfg, self.acts)

    def stop(self):
        from torch.autograd import _disable_profiler

        torch.cuda.synchronize()
        return _disable_profiler()


def _parse_span(name: str) -> Tuple[str, Optional[int]]:
    body = name[len(SPAN):]
    if "#" in body:
        body, idx = body.split("#", 1)
        return body, int(idx)
    return body, None


def _enclosing(t: int, table):
    """The last-opened span of ``table`` (start, end, ...) that holds ``t``."""
    best = None
    for x in table:
        if x[0] > t:
            break
        if t <= x[1]:
            best = x
    return best


def reduce(result) -> Trace:
    """The raw Kineto result of one stretch -> `Trace`."""
    from torch.autograd import DeviceType

    ops, runtime, dev, spans, host = {}, {}, [], [], []
    for e in result.events():
        if e.device_type() == DeviceType.CPU:
            s, t, name = e.start_ns(), e.start_ns() + e.duration_ns(), e.name()
            (runtime if name.startswith("cu") else ops)[e.correlation_id()] = s
            host.append((s, t, name))
            if name.startswith(SPAN):
                spans.append((s, t) + _parse_span(name))
        elif not (e.is_user_annotation() or e.name().startswith(SPAN)):
            dev.append(e)  # a span's mirror on the device's timeline is no activity
    host.sort()
    spans.sort()
    outer = [x for x in spans if x[3] is not None]  # request / step spans carry an index
    inner = [x for x in spans if x[3] is None]
    n_ops = n_rt = 0
    acts = []
    for e in dev:
        s = e.start_ns()
        t = s + e.duration_ns()
        link = e.linked_correlation_id()
        launch = ops.get(link)
        if launch is not None:
            n_ops += 1
        else:
            launch = runtime.get(link)
            n_rt += launch is not None
        o = _enclosing(launch if launch is not None else s, outer) or _enclosing(s, outer)
        i = _enclosing(launch, inner) if launch is not None else None
        label = None if o is None else (o[2] if i is None else i[2])
        acts.append(Activity(e.name(), s, t, label, None if o is None else o[3]))
    acts.sort(key=lambda a: a.start)
    notes = [f"{len(acts)} device activities: {n_ops} linked to a CPU op, {n_rt} to a "
             f"runtime call, {len(acts) - n_ops - n_rt} placed by time"]
    if outer:  # the traced spans, to the end of their last device activity
        w0 = outer[0][0]
        w1 = max([x[1] for x in outer] + [a.end for a in acts if a.index is not None])
    elif acts:
        w0, w1 = acts[0].start, max(a.end for a in acts)
    else:
        w0 = w1 = 0
    busy = 0
    cur_s = cur_e = None
    for a in acts:
        s, t = max(a.start, w0), min(a.end, w1)
        if t <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        busy += cur_e - cur_s
    return Trace(acts, w1 - w0, busy, host, notes)


def short(name: str, width: int = 100) -> str:
    """A kernel's name without its argument list, at most ``width`` letters."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:  # drop the parenthesised argument list, keep template arguments
        if ch == "(" and depth == 0 and out:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)[:width]


def breakdown(tr: Trace, top: int = 10) -> Dict[str, List]:
    """The device operations that took most time, and the idle gaps summed by
    what the host was doing when each began (the innermost CPU event open
    then), each list at most ``top`` long, in seconds."""
    ops = collections.Counter()
    for a in tr.activities:
        ops[short(a.name)] += a.end - a.start
    gaps = collections.Counter()
    starts = [h[0] for h in tr.host]
    last = None
    for a in tr.activities:
        if last is not None and a.start > last:
            i = bisect.bisect_right(starts, last) - 1
            label = "no host event"
            best = None
            while i >= 0 and i > bisect.bisect_right(starts, last) - 400:
                s, t, name = tr.host[i]
                if s <= last <= t and (best is None or t - s < best):
                    best, label = t - s, name
                i -= 1
            gaps[label] += a.start - last
        last = a.end if last is None else max(last, a.end)
    return {"device_ops": [[k, v / 1e9] for k, v in ops.most_common(top)],
            "idle_gaps": [[k, v / 1e9] for k, v in gaps.most_common(top)]}
