"""The rank side of the parallel parity tests (tests/test_torch_parallel.py,
test_torch_tp_forward.py, test_torch_serving_tp.py, test_torch_pp.py,
test_torch_tp_pp.py, test_torch_sp.py, test_torch_multihost.py,
test_torch_tp_train.py).  Not a test module itself.

A test module spawns its CPU ranks once (`spawn_cases`, through
``qeft_tpu_torch.parallel.multihost.launch_ranks``); every rank runs every
case in order, each case making its own mesh, and returns its outputs as
numpy arrays.  A case that raises records its traceback, so one failing
case fails its own test only.  This module imports torch and the port
only: the ranks never import JAX."""

from __future__ import annotations

import traceback

import numpy as np
import torch

from qeft_tpu_torch.models import llama as tl
from qeft_tpu_torch.parallel.mesh import make_mesh
from qeft_tpu_torch.parallel.multihost import launch_ranks


def np_(t):
    t = t.detach().cpu()
    return t.to(torch.float32).numpy() if t.dtype.is_floating_point else t.numpy()


def run_cases(cases):
    """Every case ``(name, fn, kwargs)`` on this rank -> {name: outputs or
    the traceback}."""
    out = {}
    for name, fn, kwargs in cases:
        try:
            out[name] = fn(**kwargs)
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    return out


def spawn_cases(world, cases, timeout=600.0):
    """Each rank's {case: outputs} from one spawn of ``world`` CPU ranks."""
    return launch_ranks(run_cases, world, "cpu", cases, timeout=timeout)


def result(results, name, rank=0):
    """Case ``name``'s outputs on ``rank``; a case that raised fails here."""
    res = results[rank][name]
    if "error" in res:
        raise AssertionError(f"case {name} failed on rank {rank}:\n{res['error']}")
    return res


# ---------------------------------------------------------------------------
# tensor parallelism


def tp_decode(params, cfg, cache, tok, pos, shape, names=("dp", "tp"), ragged=False):
    """One decode step (ragged with ``pos`` a [B] array) on a mesh of
    ``shape``; the logits and this rank's new cache."""
    from qeft_tpu_torch.parallel.tp_forward import (
        tp_decode_step,
        tp_decode_step_ragged,
        tp_shard_cache,
        tp_shard_packed_params,
    )

    mesh = make_mesh(shape, names, device="cpu")
    sharded = tp_shard_packed_params(params, mesh, cfg)
    local = tp_shard_cache(cache, mesh)
    if ragged:
        logits, local = tp_decode_step_ragged(sharded, torch.as_tensor(tok), local,
                                              torch.as_tensor(pos), cfg, mesh)
    else:
        logits, local = tp_decode_step(sharded, torch.as_tensor(tok), local, int(pos), cfg, mesh)
    return {"logits": np_(logits), "coords": mesh.coords(),
            **{f"cache_{k}": np_(v) for k, v in local.items()}}


def tp_window(params, cfg, cache, tokens, pos, shape, names=("dp", "tp")):
    """A window forward at offset ``pos``: the replicated logits."""
    from qeft_tpu_torch.parallel.tp_forward import (
        tp_forward_window,
        tp_shard_cache,
        tp_shard_packed_params,
    )

    mesh = make_mesh(shape, names, device="cpu")
    sharded = tp_shard_packed_params(params, mesh, cfg)
    logits, _ = tp_forward_window(sharded, torch.as_tensor(tokens), tp_shard_cache(cache, mesh),
                                  int(pos), cfg, mesh)
    return {"logits": np_(logits)}


def tp_gen(params, cfg, prompt, n, max_len, shape, names=("dp", "tp"), quantized=False):
    """`tp_generate` from an empty cache: tokens and the logits they came from."""
    from qeft_tpu_torch.parallel.tp_forward import _local_cfg, tp_generate, tp_shard_packed_params

    mesh = make_mesh(shape, names, device="cpu")
    sharded = tp_shard_packed_params(params, mesh, cfg)
    cache = tl.init_kv_cache(_local_cfg(cfg, mesh.shape["tp"]), prompt.shape[0], max_len,
                             dtype=torch.float32, device="cpu", quantized=quantized)
    toks, _, logits = tp_generate(sharded, torch.as_tensor(prompt), cache, cfg, mesh, n,
                                  return_logits=True)
    return {"tokens": toks.numpy(), "logits": np_(logits)}


def tp_burst(params, cfg, cache, tok, pos, n, shape, names=("dp", "tp")):
    """`tp_decode_burst` (greedy) against ``n`` ragged ticks one by one."""
    from qeft_tpu_torch.generate import SampleConfig
    from qeft_tpu_torch.parallel.tp_forward import (
        tp_decode_burst,
        tp_decode_step_ragged,
        tp_shard_cache,
        tp_shard_packed_params,
    )

    mesh = make_mesh(shape, names, device="cpu")
    sharded = tp_shard_packed_params(params, mesh, cfg)
    burst = tp_decode_burst(sharded, torch.as_tensor(tok), tp_shard_cache(cache, mesh),
                            torch.as_tensor(pos), cfg, mesh, n, SampleConfig(), None)
    cur, c, p, steps = torch.as_tensor(tok), tp_shard_cache(cache, mesh), torch.as_tensor(pos), []
    for _ in range(n):
        logits, c = tp_decode_step_ragged(sharded, cur, c, p, cfg, mesh)
        nxt = torch.argmax(logits, dim=-1)
        steps.append(nxt)
        cur, p = nxt[:, None], p + 1
    return {"burst": burst.numpy(), "steps": torch.stack(steps, dim=1).numpy()}


def _engine_outputs(engine, prompts, n_new):
    from qeft_tpu_torch.serving import Request

    for i, (p, n) in enumerate(zip(prompts, n_new)):
        engine.submit(Request(request_id=i, prompt=np.asarray(p), max_new_tokens=n))
    return {r.request_id: list(r.output) for r in engine.run()}


def tp_engine(params, cfg, prompts, n_new, shape, names=("dp", "tp"), **engine_kw):
    """`Engine(mesh=...)` over the requests: {request id: tokens}."""
    from qeft_tpu_torch.parallel.tp_forward import tp_shard_packed_params
    from qeft_tpu_torch.serving import Engine

    mesh = make_mesh(shape, names, device="cpu")
    sharded = tp_shard_packed_params(params, mesh, cfg)
    eng = Engine(sharded, cfg, mesh=mesh, cache_dtype=torch.float32, **engine_kw)
    return {"outputs": _engine_outputs(eng, prompts, n_new)}


def multihost_engine(params, cfg, prompts, n_new, shape, names=("dp", "tp"), **engine_kw):
    """`MultiHostEngine` of dp replicas (tp engines when tp > 1): this
    replica's outputs and the stats."""
    from qeft_tpu_torch.parallel.tp_forward import tp_shard_packed_params
    from qeft_tpu_torch.serving import MultiHostEngine, Request

    mesh = make_mesh(shape, names, device="cpu")
    if mesh.shape.get("tp", 1) > 1:
        params = tp_shard_packed_params(params, mesh, cfg)
    mh = MultiHostEngine(params, cfg, mesh=mesh, cache_dtype=torch.float32, **engine_kw)
    taken = [mh.submit(Request(request_id=i, prompt=np.asarray(p), max_new_tokens=n))
             for i, (p, n) in enumerate(zip(prompts, n_new))]
    done = {r.request_id: list(r.output) for r in mh.run()}
    return {"outputs": done, "taken": taken, "stats": mh.stats(), "coords": mesh.coords()}


def measure_tp(params, cfg, shape, names=("dp", "tp")):
    """`measure_engine_throughput(mesh=...)` at a tiny size: tokens/s > 0."""
    from qeft_tpu_torch.parallel.tp_forward import tp_shard_packed_params
    from qeft_tpu_torch.serving import measure_engine_throughput

    mesh = make_mesh(shape, names, device="cpu")
    sharded = tp_shard_packed_params(params, mesh, cfg)
    tps = measure_engine_throughput(sharded, cfg, slots=2, burst=2, requests=3, ctx=4, gen=3,
                                    reps=1, mesh=mesh)
    return {"tps": tps}


# ---------------------------------------------------------------------------
# the mesh itself


def collectives(shape, names):
    """Each collective on a small tensor of this rank's coordinates."""
    mesh = make_mesh(shape, names, device="cpu")
    out = {"coords": mesh.coords(), "rank": mesh.rank}
    x = torch.tensor([float(mesh.rank), 1.0], dtype=torch.bfloat16)
    for axis in names:
        out[f"psum_{axis}"] = np_(mesh.psum(x, axis))
        out[f"pmax_{axis}"] = np_(mesh.pmax(x, axis))
        out[f"gather_{axis}"] = np_(mesh.all_gather(x[None], axis, dim=0))
        out[f"ring_{axis}"] = np_(mesh.ppermute(x, axis))
    return out


def dense_tp_forward(params, cfg, tokens, shape, names=("dp", "tp")):
    """A dense tree on the tp layouts, its batch split over dp: this rank's
    rows' logits of a window from an empty cache."""
    from qeft_tpu_torch.parallel.multihost import host_local_batch, process_slice

    mesh = make_mesh(shape, names, device="cpu")
    rows = process_slice(tokens.shape[0], mesh)
    local = host_local_batch(tokens[rows], mesh)
    cache = tl.init_kv_cache(cfg, local.shape[0], 16, dtype=torch.float32, device="cpu")
    from qeft_tpu_torch.parallel.tp_forward import (
        tp_forward_window,
        tp_shard_cache,
        tp_shard_packed_params,
    )

    sharded = tp_shard_packed_params(params, mesh, cfg)
    logits, _ = tp_forward_window(sharded, local, tp_shard_cache(cache, mesh), 0, cfg, mesh)
    return {"logits": np_(logits), "rows": (rows.start, rows.stop)}


# ---------------------------------------------------------------------------
# pipeline, tp x pp, sequence


def pp_steps(params, cfg, cache, tok, pos0, steps, n_mb, shape, names):
    """``steps`` pipelined decode steps from a prefilled whole cache, each
    feeding back its argmax: every step's logits and this stage's cache."""
    from qeft_tpu_torch.parallel.mesh import shard_tree
    from qeft_tpu_torch.parallel.pp import pp_decode_step, pp_shardings

    mesh = make_mesh(shape, names, device="cpu")
    p_sh, c_sh = pp_shardings(params, cache, mesh)
    params_pp, cache_pp = shard_tree(params, p_sh, mesh), shard_tree(cache, c_sh, mesh)
    tok, logits = torch.as_tensor(tok), []
    for i in range(steps):
        lg, cache_pp = pp_decode_step(params_pp, tok, cache_pp, pos0 + i, cfg, mesh,
                                      n_microbatches=n_mb)
        logits.append(np_(lg))
        tok = torch.argmax(lg, dim=-1)[:, None]
    return {"logits": np.stack(logits), "coords": mesh.coords(),
            **{f"cache_{k}": np_(v) for k, v in cache_pp.items()}}


def pp_gen(params, cfg, prompt, n, max_len, shape, names, n_mb=0):
    from qeft_tpu_torch.parallel.pp import pp_generate

    mesh = make_mesh(shape, names, device="cpu")
    cache = tl.init_kv_cache(cfg, prompt.shape[0], max_len, dtype=torch.float32, device="cpu")
    return {"tokens": pp_generate(params, torch.as_tensor(prompt), cache, cfg, mesh, n,
                                  n_microbatches=n_mb).numpy()}


def tppp_step(params, cfg, cache, tok, pos, shape, names):
    """One decode step on a (dp x) pp x tp mesh from a prefilled whole cache."""
    from qeft_tpu_torch.parallel.tp_pp import tppp_decode_step, tppp_shard_params

    mesh = make_mesh(shape, names, device="cpu")
    sharded, local = tppp_shard_params(params, cache, mesh, cfg)
    logits, local = tppp_decode_step(sharded, torch.as_tensor(tok), local, int(pos), cfg, mesh)
    return {"logits": np_(logits), "coords": mesh.coords(),
            **{f"cache_{k}": np_(v) for k, v in local.items()}}


def tppp_gen(params, cfg, prompt, n, max_len, shape, names):
    from qeft_tpu_torch.parallel.tp_pp import tppp_generate, tppp_shard_params

    mesh = make_mesh(shape, names, device="cpu")
    cache = tl.init_kv_cache(cfg, prompt.shape[0], max_len, dtype=torch.float32, device="cpu")
    sharded, local = tppp_shard_params(params, cache, mesh, cfg)
    return {"tokens": tppp_generate(sharded, torch.as_tensor(prompt), local, cfg, mesh,
                                    n).numpy()}


def sp_prefill(params, cfg, prompt, shape, names):
    from qeft_tpu_torch.parallel.sp import llama_prefill_sp

    mesh = make_mesh(shape, names, device="cpu")
    logits, kv = llama_prefill_sp(params, torch.as_tensor(prompt), cfg, mesh)
    return {"logits": np_(logits), "k": np_(kv["k"]), "v": np_(kv["v"])}


def sp_prefill_then_decode(params, cfg, prompt, steps, max_len, shape, names):
    """The sp prefill's K/V scattered into a whole decode cache, then
    single-device decode steps (the JAX test's composition)."""
    from qeft_tpu_torch.parallel.sp import llama_prefill_sp

    mesh = make_mesh(shape, names, device="cpu")
    prompt = torch.as_tensor(prompt)
    logits, kv = llama_prefill_sp(params, prompt, cfg, mesh)
    s = prompt.shape[1]
    cache = tl.init_kv_cache(cfg, prompt.shape[0], max_len, dtype=torch.float32, device="cpu")
    for k in cache:
        cache[k][:, :, :, :s] = kv[k]
    tok, out = torch.argmax(logits[:, -1, :], dim=-1)[:, None], [np_(logits)]
    for i in range(steps):
        lg, cache = tl.llama_decode_step(params, tok, cache, s + i, cfg)
        out.append(np_(lg))
        tok = torch.argmax(lg, dim=-1)[:, None]
    return {"prefill": out[0], "decode": np.stack(out[1:])}


def sp_decode(params, cfg, cache, tok, pos0, steps, shape, names):
    """``steps`` decode steps over a whole prefilled cache sharded on its slot
    axis: every step's logits and this rank's slab."""
    from qeft_tpu_torch.parallel.mesh import shard_tree
    from qeft_tpu_torch.parallel.sp import llama_decode_step_sp

    mesh = make_mesh(shape, names, device="cpu")
    local = shard_tree(cache, {k: (None, None, None, "sp") for k in cache}, mesh)
    tok, logits = torch.as_tensor(tok), []
    for i in range(steps):
        lg, local = llama_decode_step_sp(params, tok, local, pos0 + i, cfg, mesh)
        logits.append(np_(lg))
        tok = torch.argmax(lg, dim=-1)[:, None]
    return {"logits": np.stack(logits), "coords": mesh.coords(),
            **{f"cache_{k}": np_(v) for k, v in local.items()}}


# ---------------------------------------------------------------------------
# multihost


def multihost_helpers(world):
    """The helpers of `parallel.multihost` inside a launched run."""
    from qeft_tpu_torch.parallel.multihost import (
        all_hosts_agree,
        global_mesh,
        host_local_batch,
        init_distributed,
        process_slice,
    )

    joined = init_distributed(device="cpu")  # already in the group: nothing to do
    mesh = global_mesh(tp=2, device="cpu")
    rows = process_slice(8, mesh)
    batch = host_local_batch(np.arange(16, dtype=np.int32).reshape(8, 2)[rows], mesh)
    return {"joined": joined, "shape": dict(mesh.shape), "coords": mesh.coords(),
            "rows": (rows.start, rows.stop), "world_rows": (process_slice(8).start,
                                                          process_slice(8).stop),
            "batch": batch.numpy(), "agree": all_hosts_agree(1.5),
            "disagree": all_hosts_agree(float(mesh.rank)),
            "within": all_hosts_agree(float(mesh.rank) * 1e-3, tol=1e-2),
            "backend": mesh.backend}


def fail_on(rank):
    """Raise on ``rank`` (launch_ranks must report it)."""
    import torch.distributed as dist

    if dist.get_rank() == rank:
        raise ValueError(f"planted failure on rank {rank}")
    return dist.get_rank()


# ---------------------------------------------------------------------------
# tensor-parallel training


def _own_slice_gather_grad(g, mesh, width):
    """A planted fault: the Megatron shortcut, this rank's own slice of the
    cotangent of a gather, which drops what the o_reorder gather sent to
    other ranks' K rows."""
    return g.narrow(-1, mesh.index("tp") * width, width).contiguous()


def tp_train_grads(params, cfg, ids, shape, planted=False, remat=False):
    """`make_tp_loss_and_grad` on this rank's dp rows of ``ids``: the loss
    and this rank's shards of the global slab gradients [L, r, N/tp] (row
    stages [L, r, N]); ``planted`` swaps in `_own_slice_gather_grad`."""
    from qeft_tpu_torch.parallel import tp_train
    from qeft_tpu_torch.parallel.multihost import process_slice

    mesh = make_mesh(shape, ("dp", "tp"), device="cpu")
    ow, frozen = tp_train.tp_shard_wct(params, mesh, cfg)
    mine = torch.as_tensor(ids[process_slice(ids.shape[0], mesh)])
    real = tp_train._gather_grad
    if planted:
        tp_train._gather_grad = _own_slice_gather_grad
    try:
        loss, grads = tp_train.make_tp_loss_and_grad(cfg, mesh, ow, frozen, remat)(
            ow, frozen, mine, mine)
    finally:
        tp_train._gather_grad = real
    return {"loss": float(loss), "coords": mesh.coords(),
            "grads": {k: np_(torch.stack(v)) for k, v in grads.items()}}


def tp_train_steps(params, cfg, ids, shape, steps, **tc):
    """``steps`` of `make_tp_train_step` (``TrainConfig(**tc)``, remat on):
    the losses and this rank's slabs after them [L, r, N/tp]."""
    from qeft_tpu_torch.finetune import TrainConfig, make_optimizer
    from qeft_tpu_torch.parallel import tp_train
    from qeft_tpu_torch.parallel.multihost import process_slice

    mesh = make_mesh(shape, ("dp", "tp"), device="cpu")
    ow, frozen = tp_train.tp_shard_wct(params, mesh, cfg)
    opt = make_optimizer(TrainConfig(**tc), ow, tp_train.tp_grad_norm(mesh, ow))
    step = tp_train.make_tp_train_step(cfg, opt, mesh, ow, frozen, remat=True)
    mine = torch.as_tensor(ids[process_slice(ids.shape[0], mesh)])
    losses = [float(step(ow, frozen, mine, mine)) for _ in range(steps)]
    return {"losses": losses, "slabs": {k: np_(torch.stack(v)) for k, v in ow.items()}}


# ---------------------------------------------------------------------------
# on the card


def tp_decode_on_card(cfg, seed, prompt, tp):
    """A random packed model built on the card from ``seed``, on a (1, tp)
    mesh: the prefill window and one decode step; the step's logits and the
    kernel launches of each."""
    from qeft_tpu_torch.ops import cuda_lib
    from qeft_tpu_torch.parallel.tp_forward import (
        _local_cfg,
        tp_decode_step,
        tp_forward_window,
        tp_shard_packed_params,
    )
    from qeft_tpu_torch.testing import build_packed_model

    mesh = make_mesh((1, tp), ("dp", "tp"))
    params = tp_shard_packed_params(build_packed_model(cfg, seed=seed, device=mesh.device),
                                    mesh, cfg)
    prompt = torch.as_tensor(prompt, device=mesh.device)
    cache = tl.init_kv_cache(_local_cfg(cfg, tp), 1, prompt.shape[1] + 8, device=mesh.device)
    with torch.inference_mode():
        cuda_lib.reset_launches()
        logits, _ = tp_forward_window(params, prompt, cache, 0, cfg, mesh)
        prefill = dict(cuda_lib.launches)
        cuda_lib.reset_launches()
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        step, _ = tp_decode_step(params, tok, cache, prompt.shape[1], cfg, mesh)
        torch.cuda.synchronize()
    return {"logits": np_(step), "prefill": prefill, "decode": dict(cuda_lib.launches),
            "staged": mesh.staged}


def tp_train_on_card(cfg, seed, ids, tp):
    """A random packed model built on the card from ``seed``, on a (1, tp)
    mesh: one `make_tp_loss_and_grad` (remat on) over ``ids``; the loss,
    this rank's slab gradients and the kernel launches."""
    from qeft_tpu_torch.ops import cuda_lib
    from qeft_tpu_torch.parallel.tp_train import make_tp_loss_and_grad, tp_shard_wct
    from qeft_tpu_torch.testing import build_packed_model

    mesh = make_mesh((1, tp), ("dp", "tp"))
    ow, frozen = tp_shard_wct(build_packed_model(cfg, seed=seed, device=mesh.device), mesh, cfg)
    ids = torch.as_tensor(ids, device=mesh.device)
    loss_and_grad = make_tp_loss_and_grad(cfg, mesh, ow, frozen, remat=True)
    cuda_lib.reset_launches()
    loss, grads = loss_and_grad(ow, frozen, ids, ids)
    torch.cuda.synchronize()
    return {"loss": float(loss), "launches": dict(cuda_lib.launches),
            "grads": {k: np_(torch.stack(v)) for k, v in grads.items()}}
