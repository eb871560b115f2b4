"""The readers of the program's own spans (``portbench/programspans.py``) on
synthetic traces, and the spans reaching a reduced trace under the
profiler as ``trace.Tracer`` starts it (CPU activity only, here)."""

import dataclasses

import pytest
import torch

from portbench import programspans, run, trace
from portbench.tests.small import BENCH
from portbench.trace import Activity, Trace

NEW = {"loop_setup_ms.decode", "driver_idle_share.decode", "model_idle_share.decode",
       "linear_idle_share.decode", "driver_idle_share.train", "model_idle_share.train",
       "linear_idle_share.train"}
SHARES = {"decode": ["driver_idle_share.decode", "model_idle_share.decode",
                     "linear_idle_share.decode"],
          "train": ["driver_idle_share.train", "model_idle_share.train",
                    "linear_idle_share.train"]}


class Run:
    def __init__(self, tr):
        self.trace = tr


def make(acts, host):
    """A `Trace` as ``trace.reduce`` builds it: activities (start, end, index)
    and host events (start, end, name), the window and busy time computed
    from them as ``reduce`` computes them."""
    acts = sorted((Activity("k", s, t, "request", i) for s, t, i in acts), key=lambda a: a.start)
    host = sorted(host)
    outer = [(s, t) for s, t, n in host if n.startswith(trace.SPAN) and "#" in n]
    w0 = min(s for s, _ in outer)
    w1 = max([t for _, t in outer] + [a.end for a in acts if a.index is not None])
    busy, cur_s, cur_e = 0, None, None
    for a in acts:
        s, t = max(a.start, w0), min(a.end, w1)
        if t <= s:
            continue
        if cur_e is None or s > cur_e:
            busy += 0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    busy += 0 if cur_e is None else cur_e - cur_s
    return Trace(acts, w1 - w0, busy, host)


def read(name, tr):
    return run.load_reader(name).read(Run(tr))


def idle_share(tr):
    return run.load_reader("idle_share.decode").read(Run(tr))


# one request 0..1000 ns: busy 0-100, 300-400, 700-800, 900-1000 (idle 600 ns)
BASE_ACTS = [(0, 100, 0), (300, 400, 0), (700, 800, 0), (900, 1000, 0)]


def test_the_layers_and_outside_add_up_to_the_idle_share():
    host = [(0, 1000, "portbench.request#0"),
            (0, 350, "qeft.generate.prefill"),        # idle 100-300 under it ...
            (150, 250, "qeft.model.block"),           # ... but 150-250 under the block
            (180, 220, "aten::mm"),                   # no program span: chooses nothing
            (400, 650, "qeft.generate.replay"),       # idle 400-650
            (650, 700, "cudaStreamSynchronize")]      # idle 650-700 outside, and 800-900
    tr = make(BASE_ACTS, host)
    split = programspans.idle_split(tr)
    assert split["idle"] == {"drivers": 100 + 250, "model": 100, "linear": 0, "outside": 150}
    assert split["spans"] == {"qeft.generate.prefill": 100, "qeft.generate.replay": 250,
                              "qeft.model.block": 100}
    shares = [read(n, tr) for n in SHARES["decode"]]
    assert shares[2] is None  # no linear span in the window: nothing, not 0
    outside = 100.0 * split["idle"]["outside"] / split["window"]
    assert sum(shares[:2]) + outside == pytest.approx(idle_share(tr), abs=1e-12)
    assert idle_share(tr) == pytest.approx(60.0)


def test_idle_time_under_nested_spans_goes_to_the_innermost():
    host = [(0, 1000, "portbench.request#0"),
            (0, 1000, "qeft.generate.prefill"),
            (50, 950, "qeft.model.block"),
            (100, 850, "qeft.linear.forward")]
    tr = make(BASE_ACTS, host)
    got = programspans.idle_split(tr)["idle"]
    # idle 100-300, 400-700, 800-850 under the linear; 850-900 under the block
    assert got == {"drivers": 0, "model": 50, "linear": 550, "outside": 0}
    for name, want in zip(SHARES["decode"], (0.0, 5.0, 55.0)):
        assert read(name, tr) == pytest.approx(want)


def test_overlapping_spans_of_two_threads_go_to_the_shorter():
    # the main thread waits in backward; autograd's thread runs a linear's
    # backward that starts inside it and outlives a shorter block span
    host = [(0, 1000, "portbench.step#0"),
            (50, 1000, "qeft.finetune.backward"),
            (100, 700, "qeft.linear.backward"),       # 600 ns long
            (350, 750, "qeft.model.block")]           # 400 ns long: shorter
    tr = make(BASE_ACTS, host)
    got = programspans.idle_split(tr)["idle"]
    # 100-300 linear; 400-700 block (the shorter); 800-900 backward
    assert got == {"drivers": 100, "model": 300, "linear": 200, "outside": 0}
    shares = [read(n, tr) for n in SHARES["train"]]
    assert sum(shares) == pytest.approx(run.load_reader("idle_share.train").read(Run(tr)))


def test_a_trace_without_program_spans_gives_none():
    host = [(0, 1000, "portbench.request#0"), (0, 300, "portbench.prefill"),
            (100, 200, "aten::mm"), (400, 500, "cudaGraphLaunch")]
    tr = make(BASE_ACTS, host)
    assert idle_share(tr) == pytest.approx(60.0)
    for name in NEW:
        assert read(name, tr) is None, name
    assert all(run.load_reader(n).read(Run(None)) is None for n in NEW)


def test_spans_outside_the_window_choose_nothing():
    host = [(0, 1000, "portbench.request#0"), (-500, -10, "qeft.linear.forward"),
            (1100, 1200, "qeft.model.block")]
    tr = make(BASE_ACTS, host)
    assert programspans.idle_split(tr) is None


def test_loop_setup_is_the_mean_a_request():
    host = [(0, 1000, "portbench.request#0"),
            (100, 130, "qeft.generate.first_step"), (130, 200, "qeft.generate.capture"),
            (1000, 3000, "portbench.request#1"),
            (1100, 1150, "qeft.generate.first_step"), (1150, 1200, "qeft.generate.capture"),
            (1200, 2900, "qeft.generate.replay")]
    acts = BASE_ACTS + [(1000, 2950, 1)]
    tr = make(acts, host)
    # request 0: 30 + 70 ns; request 1: 50 + 50 ns, then 50 + 300 ns
    assert read("loop_setup_ms.decode", tr) == pytest.approx(100 / 1e6)
    host[-2] = (1150, 1450, "qeft.generate.capture")
    tr = make(acts, host)
    assert read("loop_setup_ms.decode", tr) == pytest.approx((100 + 350) / 2 / 1e6)


def test_the_window_is_the_one_reduce_sets():
    host = [(100, 1000, "portbench.request#0"), (50, 80, "qeft.model.block"),
            (100, 300, "portbench.prefill")]
    tr = make(BASE_ACTS + [(1000, 1200, 0), (1300, 1400, None)], host)
    assert programspans.window(tr) == (100, 1200)
    assert tr.window_ns == 1100
    tr = dataclasses.replace(tr, host=tr.host + [(300, 1200, "qeft.linear.forward")])
    split = programspans.idle_split(tr)
    assert sum(split["idle"].values()) == tr.window_ns - tr.busy_ns


def test_the_seven_entries_name_their_readers_and_cells():
    entries = {m["name"]: m for m in BENCH["per_layer"] if m["name"] in NEW}
    assert set(entries) == NEW
    for name, m in entries.items():
        assert callable(run.load_reader(name).read)
        assert m["source"] == "device_trace" and m["better"] == "lower"
        phase = name.rsplit(".", 1)[1]
        cells = run.cell_metrics(BENCH, m["workloads"][0], True)
        assert name in {c["name"] for c in cells}
        assert m["moves"] == ("gen_tokens_s" if phase == "decode" else "train_tokens_s")


def test_program_spans_reach_the_reduced_trace_under_the_low_level_profiler():
    """``Tracer`` starts Kineto through ``_enable_profiler``, not the
    ``torch.profiler`` context: a span sees it recording and opens a range,
    which `reduce` keeps among the host events."""
    from torch.autograd import (ProfilerConfig, ProfilerState, _disable_profiler,
                                _enable_profiler, _prepare_profiler)
    from torch.profiler import ProfilerActivity

    from qeft_tpu_torch.utils import span

    acts = {ProfilerActivity.CPU}
    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                         torch._C._profiler._ExperimentalConfig())
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts)
    try:
        with trace.span("request", 0):
            with span("qeft.model.block"):
                torch.ones(8) + 1
    finally:
        result = _disable_profiler()
    tr = trace.reduce(result)
    names = [name for _, _, name in tr.host]
    assert "qeft.model.block" in names and "portbench.request#0" in names
    (s, t), = [(s, t) for s, t, n in tr.host if n == "qeft.model.block"]
    (s0, t0), = [(s, t) for s, t, n in tr.host if n == "portbench.request#0"]
    assert s0 <= s < t <= t0
    assert not any(a.name.startswith(programspans.PREFIX) for a in tr.activities)
