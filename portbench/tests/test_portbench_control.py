"""The control at a size a test run holds: the reference put in the
program's place and computed in float8, one precision below the
configurations' bfloat16, read as ``control.py`` reads it on the card."""

import pytest
import torch

from portbench import control, run
from portbench.tests import small

SEEDS = (1, 2, 3)


def readings(cell):
    w = next(w for w in small.BENCH["workloads"] if w["name"] == cell)
    cfg = small.config(w["config"], layers=4, hidden=512, vocab=2048)
    mix = small.traffic(w["traffic"])
    read = control.decode_readings if mix["kind"] == "decode" else control.train_readings
    return [read(run.Ctx(cfg, mix, s, 0.0, False, torch.device("cpu")), True) for s in SEEDS]


@pytest.mark.parametrize("cell", ["opt-6.7b.chat-b1", "falcon-7b.batch8"])
def test_float8_serves_farther_from_the_reference(cell):
    rows = readings(cell)
    program = max(r["program"]["gap"] for r in rows)
    low = max(r["control"]["gap"] for r in rows)
    assert low > 0 and low >= 3 * program


def test_float8_training_is_not_correct():
    limits = run.load_json(run.find("cells", "opt-6.7b.wct-train"))["limits"]
    for r in readings("opt-6.7b.wct-train"):
        assert r["control"]["grad"] > 3 * r["program"]["grad"]
        assert any(r["control"][k] > v for k, v in limits.items())
        assert any(r["half_batch"][k] > v for k, v in limits.items())
