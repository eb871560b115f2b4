"""The port's multi-host dry run (``qeft_tpu_torch/multihost_dryrun.py``, the
counterpart of scripts/multihost_dryrun.py) on Gloo ranks on the CPU: 2
hosts x tp 2, the JAX script's model in f32.  Its three legs: WCT steps on
each host's rows with the losses equal on every rank; the dp-sharded
decode within the JAX script's bounds of the full-batch reference; the
MultiHostEngine's tokens equal to the single-process engine's, request for
request; and the CLI's last line."""

import os
import subprocess
import sys

import numpy as np
import pytest

from qeft_tpu_torch import multihost_dryrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ranks():
    return multihost_dryrun.run(device="cpu")


def test_the_mesh_is_two_hosts_of_tp_2(ranks):
    assert [r["coords"] for r in ranks] == [{"dp": d, "tp": t} for d in (0, 1) for t in (0, 1)]
    assert all(r["device"] == "cpu" for r in ranks)


def test_train_steps_agree_across_hosts(ranks):
    losses = ranks[0]["train"]["losses"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert all(r["train"]["losses"] == losses for r in ranks)


def test_dp_sharded_decode_matches_the_full_batch_reference(ranks):
    for rank, r in enumerate(ranks):
        d = r["decode"]
        assert d["bound"] == 1e-3 and d["max_logit_diff"] < 1e-3
        assert d["rows"] == ((0, 2) if rank < 2 else (2, 4))


def test_multihost_engine_equals_the_single_process_engine(ranks):
    for rank, r in enumerate(ranks):
        e = r["engine"]
        assert e["requests"] == ([0, 2, 4] if rank < 2 else [1, 3, 5])
        assert e["stats"]["requests_total"] == 6 and e["stats"]["tokens_total"] == 24
        assert all(len(e["outputs"][i]) == 4 for i in e["requests"])
    # the tp ranks of one host serve the same tokens
    assert ranks[0]["engine"]["outputs"] == ranks[1]["engine"]["outputs"]


def test_the_cli_prints_ok():
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-m", "qeft_tpu_torch.multihost_dryrun", "--device",
                           "cpu"], capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "MULTIHOST DRYRUN OK" and len(lines) == 5
