"""Phase timing and traces of the port (``qeft_tpu_torch/utils/profiling.py``):
tests/test_profiling.py's case, a synchronisation before the clock stops,
and a Chrome trace written by ``profile_trace`` on the CPU (on the card it
also records CUDA activity; ``chip_smoke.py`` checks it names K1)."""

import json
import time

import pytest
import torch

from qeft_tpu_torch.utils import Telemetry, phase_timer, profile_trace


def test_phase_timer_records():
    t = Telemetry()
    with phase_timer("work", t):
        time.sleep(0.01)
    with phase_timer("work", t):
        time.sleep(0.01)
    s = t.summary()
    assert s["work"]["count"] == 2
    assert s["work"]["total_s"] >= 0.02
    assert "work" in t.dump()


def test_phase_timer_synchronises_before_stopping(tmp_path):
    t, seen = Telemetry(), []
    with phase_timer("a", t, sync=lambda: seen.append(time.perf_counter())):
        pass
    with phase_timer("b", t, sync="cpu"):  # a device: nothing to wait for on the CPU
        pass
    assert len(seen) == 1 and t.counts == {"a": 1, "b": 1}
    t.dump(str(tmp_path / "t.json"))
    assert json.load(open(tmp_path / "t.json"))["a"]["count"] == 1


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path), device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.key for e in prof.key_averages()}
    assert any("mm" in n for n in names)
    trace = json.load(open(tmp_path / "trace.json"))
    assert trace["traceEvents"]
    with profile_trace(str(tmp_path / "off"), enabled=False) as prof:
        pass
    assert prof is None and not (tmp_path / "off").exists()


def test_profile_trace_needs_a_gpu_unless_cpu_is_named(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with profile_trace(str(tmp_path)):
            pass
