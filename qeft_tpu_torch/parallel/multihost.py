"""Joining the ranks of a run into one process group, the global (dp, tp)
mesh, host-local data feeding, and `launch_ranks`, which starts the ranks
of a run on one host.  Counterpart of ``qeft_tpu/parallel/multihost.py``.

A JAX process drives all of its host's devices; here one rank drives one
device, so a "process" of the JAX package is a rank and a host's devices
are its local ranks.  `global_mesh` puts ``dp`` outer (across hosts) and
``tp`` inner (the ranks of one host), so tensor-parallel collectives stay
inside a host.  A single process with nothing configured is a no-op, as in
JAX.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import socket
import traceback
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from qeft_tpu_torch.parallel.mesh import Mesh, choose_backend, make_mesh, rank_device

# how long a collective waits for its peers before it fails (a rank that
# dies mid-run otherwise leaves the others waiting for ever)
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=900)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None, process_id: Optional[int] = None,
                     backend: Optional[str] = None, device=None) -> bool:
    """Join the run's process group; returns True if one was joined.

    The arguments default from JAX's variables (``JAX_COORDINATOR_ADDRESS``
    host:port, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``), then torchrun's
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  With
    neither set, a single process: nothing to join.  The backend follows
    `mesh.choose_backend` for this rank's device (``device`` None: the GPU,
    which must exist)."""
    env = os.environ
    if dist.is_initialized():
        return True
    if coordinator_address is None:
        coordinator_address = env.get("JAX_COORDINATOR_ADDRESS")
        if coordinator_address is None and env.get("MASTER_ADDR"):
            coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        n = env.get("JAX_NUM_PROCESSES") or env.get("WORLD_SIZE")
        num_processes = int(n) if n else None
    if process_id is None:
        r = env.get("JAX_PROCESS_ID") or env.get("RANK")
        process_id = int(r) if r else None
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a distributed run needs a coordinator address, a process count and "
                         "a process id")
    dev = rank_device(device, process_id)
    dist.init_process_group(choose_backend(dev, num_processes, backend),
                            init_method=f"tcp://{coordinator_address}", rank=process_id,
                            world_size=num_processes, timeout=COLLECTIVE_TIMEOUT)
    return True


def _local_world() -> int:
    world = dist.get_world_size() if dist.is_initialized() else 1
    return int(os.environ.get("LOCAL_WORLD_SIZE", world))


def global_mesh(tp: Optional[int] = None, axis_names=("dp", "tp"), backend: Optional[str] = None,
                device=None) -> Mesh:
    """The (dp, tp) mesh over every rank of the run; ``tp`` defaults to the
    ranks of one host, so each tensor-parallel group stays inside a host."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    tp = tp or _local_world()
    if world % tp:
        raise ValueError(f"{world} ranks do not split into tp groups of {tp}")
    return make_mesh((world // tp, tp), axis_names, backend=backend, device=device)


def host_local_batch(local_batch: np.ndarray, mesh: Mesh, axis: str = "dp") -> torch.Tensor:
    """This rank's rows of the global batch, on its device.  Every rank
    passes only its own shard (the rows `process_slice` names), so no rank
    holds the whole batch; the ranks of one ``axis`` coordinate pass the
    same rows."""
    if axis not in mesh.shape:
        raise ValueError(f"the mesh has no axis {axis!r}")
    return torch.as_tensor(np.asarray(local_batch), device=mesh.device)


def process_slice(n_global: int, mesh: Optional[Mesh] = None, axis: str = "dp") -> slice:
    """The contiguous rows of a length-``n_global`` batch this rank feeds:
    by its ``axis`` coordinate on ``mesh``, or, without one, by its rank in
    the world (JAX's process index).  ``n_global`` must divide evenly."""
    if mesh is not None:
        n, i = mesh.shape.get(axis, 1), mesh.index(axis)
    else:
        n = dist.get_world_size() if dist.is_initialized() else 1
        i = dist.get_rank() if dist.is_initialized() else 0
    if n_global % n:
        raise ValueError(f"global batch {n_global} must be divisible by {n} "
                         "(pad or trim the batch explicitly)")
    per = n_global // n
    return slice(i * per, (i + 1) * per)


def all_hosts_agree(value: float, tol: float = 0.0) -> bool:
    """Whether every rank holds ``value`` within ``tol`` (a check of the
    collective wiring, on the CPU through the world group)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return True
    mine = torch.tensor([value], dtype=torch.float64)
    if dist.get_backend() == "nccl":
        mine = mine.cuda()
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    got = torch.cat(parts).cpu()
    return bool(((got - got[0]).abs() <= tol).all())


# ---------------------------------------------------------------------------
# ranks on one host


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world: int, port: int, device: str, args, results) -> None:
    """A spawned rank: join the group, run ``fn(*args)``, report."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # every rank is on this host
    try:
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:  # the ranks share the host's cores
            torch.set_num_threads(1)
        dist.init_process_group(choose_backend(dev, world), init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world, timeout=COLLECTIVE_TIMEOUT)
        # plain pickle bytes: torch's queue pickler would share a tensor's
        # storage through this process, which may have exited by the time
        # the parent reads it
        results.put((rank, True, pickle.dumps(fn(*args))))
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch_ranks(fn, world: int, device=None, *args, timeout: float = 3600.0) -> List:
    """Run ``fn(*args)`` on ``world`` ranks of this host, each a process
    (``spawn``) in one process group (a free port on 127.0.0.1, the backend
    of `mesh.choose_backend`), rank r on ``cuda:(r % device_count)`` or, with
    ``device="cpu"``, the CPU (one thread a rank).  ``fn`` must be importable
    and makes its mesh itself (`mesh.make_mesh`); what it returns must be
    host values (a tensor on the card does not outlive its rank).  Returns
    each rank's return value, in rank order; a rank that raises or dies
    fails the call with its traceback, and the other ranks are stopped."""
    device = str(rank_device(device, 0).type)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, port, device, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out: List = [None] * world
    pending = set(range(world))
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
    try:
        while pending:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r in pending if procs[r].exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} without a result")
                if datetime.datetime.now() > deadline:
                    raise TimeoutError(f"ranks {sorted(pending)} did not finish in {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{payload}")
            out[rank] = pickle.loads(payload)
            pending.discard(rank)
    finally:
        for p in procs:
            if pending:
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    return out
