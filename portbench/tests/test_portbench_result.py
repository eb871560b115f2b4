"""The result line: the five keys the contract reads, the numbers compared
last, and no line at all without a card or without the program."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import run
from portbench.tests import small

ROOT = run.HERE.parent


@pytest.mark.parametrize("cell", [w["name"] for w in small.BENCH["workloads"]])
def test_result_has_the_five_keys_and_the_check_last(cell):
    res = run.execute(small.BENCH, cell, 2**31 + 99, 0.3, False, torch.device("cpu"),
                      files=small.files(cell))
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert list(res)[-1] == "check"
    assert res["correct"] is True and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, m in res["metrics"].items():
        assert m["value"] > 0 and m["unit"], name
    assert all(set(v) == {"value", "limit"} for v in res["check"].values())
    json.dumps(res)


def run_cli(cwd):
    env = dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "portbench", "--workload", "opt-6.7b.chat-b1",
                           "--seed", str(2**32 + 5), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    out = run_cli(ROOT)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_runs_on_the_card(card, trace):
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", "opt-6.7b.chat-b1",
                          "--seed", "2147483649", "--seconds", "3", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=900, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert out.stderr.strip().splitlines()[-1].startswith("check gap ")
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert "qgemv_roofline.decode" in res["metrics"]
