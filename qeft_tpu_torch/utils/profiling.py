"""Spans and device traces of the port.

`span` names a stretch of the program (``qeft.<layer>.<what>``, the list in
``PERF.md`` §3) as a ``torch.profiler`` range, so that it lies on the device
trace's own clock beside the kernels it launched; it costs one flag check
when no profiler records.  `profile_trace` records a ``torch.profiler``
trace of the CPU and, on the card, CUDA activity and writes it to
``logdir`` as a Chrome trace (chrome://tracing, Perfetto).
"""

from __future__ import annotations

import contextlib
import os

import torch

_NO_RANGE = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler records
    on this thread, else a context that does nothing (no dispatcher call).
    No range opens while the current stream captures a CUDA graph: the
    capture's host time stays with the span around the capture."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_RANGE
    if torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing():
        return _NO_RANGE
    return torch.profiler.record_function(name)


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
