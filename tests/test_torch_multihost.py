"""The port's multi-process scaffolding (``qeft_tpu_torch.parallel.multihost``),
the cases of tests/test_multihost.py and more: in one process
``init_distributed`` is a no-op and every helper degrades as JAX's does;
two processes join through JAX's variables and through torchrun's; four
ranks launched by ``launch_ranks`` lay out the (dp, tp) mesh, feed their
own rows and agree on a scalar; a rank that fails fails the launch with its
traceback."""

import os
import subprocess
import sys

import numpy as np
import pytest

from qeft_tpu_torch.parallel.mesh import Mesh
from qeft_tpu_torch.parallel.multihost import (
    _free_port,
    all_hosts_agree,
    global_mesh,
    host_local_batch,
    init_distributed,
    launch_ranks,
    process_slice,
)
from tests import torch_ranks as R

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DIST_VARS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "MASTER_ADDR",
              "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_WORLD_SIZE")


def test_single_process_helpers(monkeypatch):
    for v in _DIST_VARS:
        monkeypatch.delenv(v, raising=False)
    assert init_distributed(device="cpu") is False  # nothing configured: no-op
    mesh = global_mesh(device="cpu")
    assert mesh.shape == {"dp": 1, "tp": 1} and mesh.groups == {}
    batch = np.arange(16, dtype=np.int32).reshape(8, 2)
    np.testing.assert_array_equal(host_local_batch(batch, mesh).numpy(), batch)
    assert process_slice(8) == slice(0, 8)
    assert all_hosts_agree(3.0)
    with pytest.raises(ValueError, match="divisible"):
        process_slice(8, Mesh({"dp": 3, "tp": 1}))


_CHILD = """
from qeft_tpu_torch.parallel.multihost import all_hosts_agree, global_mesh, init_distributed
import torch.distributed as dist
joined = init_distributed(device="cpu")
mesh = global_mesh(tp=1, device="cpu")
print("OK", joined, dist.get_rank(), dict(mesh.shape), all_hosts_agree(1.0), flush=True)
dist.destroy_process_group()  # a group left to interpreter exit can abort its process
"""


@pytest.mark.parametrize("style", ["jax", "torchrun"])
def test_two_processes_join_from_the_environment(style):
    """Two processes configured only by the environment join one group
    (Gloo on the CPU) and see a (dp 2, tp 1) mesh."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if k not in _DIST_VARS}
        env["PYTHONPATH"] = REPO
        env["GLOO_SOCKET_IFNAME"] = "lo"
        if style == "jax":
            env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", JAX_NUM_PROCESSES="2",
                       JAX_PROCESS_ID=str(rank))
        else:
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                       RANK=str(rank))
        procs.append(subprocess.Popen([sys.executable, "-c", _CHILD], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=120) for p in procs]
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-2000:]
        assert f"OK True {rank} {{'dp': 2, 'tp': 1}} True" in out


@pytest.fixture(scope="module")
def run():
    return R.spawn_cases(4, [("helpers", R.multihost_helpers, dict(world=4))])


def test_launched_ranks_share_one_mesh(run):
    """dp outer, tp inner; each rank feeds its dp row's half of the batch."""
    batch = np.arange(16, dtype=np.int32).reshape(8, 2)
    for rank in range(4):
        res = R.result(run, "helpers", rank)
        assert res["joined"] is True and res["backend"] == "gloo"
        assert res["shape"] == {"dp": 2, "tp": 2}
        assert res["coords"] == {"dp": rank // 2, "tp": rank % 2}
        lo = 4 * (rank // 2)
        assert res["rows"] == (lo, lo + 4)
        assert res["world_rows"] == (2 * rank, 2 * rank + 2)
        np.testing.assert_array_equal(res["batch"], batch[lo: lo + 4])
        assert res["agree"] is True and res["disagree"] is False and res["within"] is True


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(RuntimeError, match="planted failure on rank 1"):
        launch_ranks(R.fail_on, 2, "cpu", 1, timeout=120)
