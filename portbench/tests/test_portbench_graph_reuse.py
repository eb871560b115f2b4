"""``graph_reuse_share.decode`` on synthetic reduced traces: the share of
traced requests that hold no capture of the decode step."""

import pytest

from portbench import run
from portbench.trace import Activity, Trace


class Run:
    def __init__(self, tr):
        self.trace = tr


def _read(host):
    acts = [Activity("k", 0, 10, "request", 0)]
    return run.load_reader("graph_reuse_share.decode").read(Run(Trace(acts, 10, 10,
                                                                      sorted(host))))


def _request(i, capture):
    """Request ``i`` over [1000 i, 1000 i + 900): prefill, first step, the
    capture where ``capture``, replays."""
    s = 1000 * i
    host = [(s, s + 900, f"portbench.request#{i}"),
            (s + 10, s + 100, "qeft.generate.prefill"),
            (s + 100, s + 200, "qeft.generate.first_step"),
            (s + 300, s + 800, "qeft.generate.replay")]
    if capture:
        host.append((s + 200, s + 300, "qeft.generate.capture"))
    return host


@pytest.mark.parametrize("captures,share", [((True, True), 0.0), ((False, False), 100.0),
                                            ((True, False), 50.0), ((False, True), 50.0),
                                            ((True,), 0.0), ((False, False, True, False), 75.0)])
def test_share_of_requests_without_a_capture(captures, share):
    host = [e for i, c in enumerate(captures) for e in _request(i, c)]
    assert _read(host) == pytest.approx(share)


def test_nothing_without_request_spans_or_program_spans():
    assert _read([(200, 300, "qeft.generate.capture"), (0, 900, "portbench.step#0")]) is None
    assert _read([(0, 900, "portbench.request#0"), (10, 100, "aten::mm")]) is None
    assert run.load_reader("graph_reuse_share.decode").read(Run(None)) is None
