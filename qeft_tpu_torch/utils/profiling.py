"""Phase timing and device traces.  Counterpart of
``qeft_tpu/utils/profiling.py``.

`Telemetry` is a registry of phase times, `phase_timer` times a phase into
it (the clock stopped after ``sync``: a callable, or a device whose work is
synchronised first), and `profile_trace` records a ``torch.profiler`` trace
of the CPU and, on the card, CUDA activity and writes it to ``logdir`` as a
Chrome trace (chrome://tracing, Perfetto).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class Telemetry:
    """Phase times by name: their total, count and mean."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def record(self, name: str, seconds: float) -> None:
        self.totals[name] += seconds
        self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {name: {"total_s": round(self.totals[name], 4), "count": self.counts[name],
                       "mean_s": round(self.totals[name] / max(self.counts[name], 1), 6)}
                for name in sorted(self.totals)}

    def dump(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.summary(), indent=1)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s


GLOBAL = Telemetry()


def _synchronise(sync) -> None:
    if sync is None:
        return
    if callable(sync):
        sync()
        return
    device = torch.device(sync)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def phase_timer(name: str, telemetry: Optional[Telemetry] = None, sync=None):
    """Time the block as phase ``name`` (into `GLOBAL` by default).  The
    clock stops after ``sync``: a callable (``lambda: out.cpu()``), or a
    device (``"cuda"``, a ``torch.device``) synchronised first -- without
    it an asynchronous launch is timed as its enqueue."""
    t = telemetry or GLOBAL
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _synchronise(sync)
        t.record(name, time.perf_counter() - t0)


@contextlib.contextmanager
def profile_trace(logdir: str, enabled: bool = True, device=None):
    """Trace the block with ``torch.profiler`` and write it to
    ``logdir/trace.json`` (Chrome format).  ``device`` None means the GPU,
    which must exist (CPU and CUDA activity); ``"cpu"`` traces the CPU only.
    Yields the profiler (``key_averages()`` gives the time by kernel), or
    None when not ``enabled``."""
    from qeft_tpu_torch.device import resolve_device

    if not enabled:
        yield None
        return
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
