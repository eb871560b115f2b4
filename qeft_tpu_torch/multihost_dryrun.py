"""Dry run of the multi-host path: 2 "hosts" x tp 2 ranks on one machine.
Counterpart of ``scripts/multihost_dryrun.py``.

    python -m qeft_tpu_torch.multihost_dryrun                  # on the card
    python -m qeft_tpu_torch.multihost_dryrun --device cpu     # Gloo on the CPU

The launcher starts ``HOSTS * TP`` ranks on this machine
(`parallel.multihost.launch_ranks`) and lays the global (dp = HOSTS, tp)
mesh over them: a JAX process, which drives its host's devices, is here the
tp group of one dp coordinate.  Every rank builds the same packed model
from one seed and runs the three legs of the JAX dry run:

1. weak-column tuning, each host feeding only its `process_slice` of the
   global batch, through `parallel.tp_train.make_tp_train_step` (JAX runs
   its GSPMD train step here; the port has no GSPMD): the losses of every
   rank agree within 1e-6 (`all_hosts_agree`);
2. a dp-sharded decode, each host prefilling its own requests on the tp
   layout and decoding them teacher-forced with the tokens of a full-batch
   single-device reference that every rank computes itself: on the CPU in
   f32, logits within 1e-3 and the argmax equal wherever the reference's
   top-two margin exceeds 1e-2 (the JAX script's bounds); on the card in
   bf16 (the kernels' dtype), within 0.1 of the logit scale and the argmax
   equal wherever the margin exceeds that bound;
3. `serving.MultiHostEngine` (a tp engine per host, requests routed by id)
   against the single-process `Engine` over the whole stream, request for
   request, and the cluster totals of its `stats`.

The CLI runs the JAX script's model (vocabulary 512, width 256, 2 layers);
`run` takes another configuration and `Sizes`.  Each rank returns host
values, on the card with each leg's kernel launches; the
launcher prints ``MULTIHOST DRYRUN OK`` when every rank passed.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Dict

import numpy as np
import torch

from qeft_tpu_torch.models.llama import LlamaConfig

# the JAX script's layout: 2 "hosts" (dp), each a tp 2 group
HOSTS = 2
TP = 2
# scripts/multihost_dryrun.py's model
DRYRUN_CFG = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                         num_heads=4, num_kv_heads=4, head_dim=64, max_position_embeddings=128)


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The work of each leg (the JAX script's by default)."""

    train_rows: int = 2      # rows a host feeds per step
    train_seq: int = 32
    train_steps: int = 2
    decode_rows: int = 2     # requests a host decodes
    decode_ctx: int = 8
    decode_steps: int = 3
    requests: int = 6        # the engine's global stream
    new_tokens: int = 4
    group_size: int = 64
    weak: int = 16           # r, the weak columns of each linear


def _leg(out: Dict, name: str, device: torch.device, fn):
    """``fn()`` as leg ``name``: its seconds and, on the card, the kernel
    launches it made (the counts set to 0 just before it)."""
    from qeft_tpu_torch.ops import cuda_lib

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    cuda_lib.reset_launches()
    tick = time.perf_counter()
    res = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    res["seconds"] = time.perf_counter() - tick
    res["launches"] = dict(cuda_lib.launches)
    out[name] = res


def _train_leg(params, cfg, mesh, sizes: Sizes) -> Dict:
    from qeft_tpu_torch.finetune import TrainConfig, make_optimizer
    from qeft_tpu_torch.parallel.multihost import all_hosts_agree, host_local_batch, process_slice
    from qeft_tpu_torch.parallel.tp_train import make_tp_train_step, tp_grad_norm, tp_shard_wct

    ow, frozen = tp_shard_wct(params, mesh, cfg)
    opt = make_optimizer(TrainConfig(learning_rate=1e-4, total_steps=4, remat=True), ow,
                         tp_grad_norm(mesh, ow))
    step = make_tp_train_step(cfg, opt, mesh, ow, frozen, remat=True)
    n_global = mesh.shape["dp"] * sizes.train_rows
    ids_global = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                   (n_global, sizes.train_seq))
    losses = []
    for _ in range(sizes.train_steps):
        ids = host_local_batch(ids_global[process_slice(n_global, mesh)], mesh)
        losses.append(float(step(ow, frozen, ids, ids)))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"a training loss is not finite: {losses}")
    if not all_hosts_agree(losses[-1], tol=1e-6):
        raise AssertionError("the loss differs across hosts")
    return {"losses": losses}


def _decode_leg(params, cfg, mesh, sizes: Sizes) -> Dict:
    """Leg 2: this host's rows prefilled and decoded on the tp layout,
    teacher-forced with the full-batch single-device reference's tokens."""
    from qeft_tpu_torch.models.llama import init_kv_cache, llama_decode_step, llama_prefill
    from qeft_tpu_torch.parallel.multihost import host_local_batch, process_slice
    from qeft_tpu_torch.parallel.tp_forward import (
        _local_cfg,
        tp_decode_step,
        tp_forward_window,
        tp_shard_packed_params,
    )

    dev = mesh.device
    n_global, ctx, steps = mesh.shape["dp"] * sizes.decode_rows, sizes.decode_ctx, \
        sizes.decode_steps
    sl = process_slice(n_global, mesh)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (n_global, ctx))
    max_len = -(-(ctx + steps + 1) // 8) * 8
    dtype = params["embed"].dtype
    with torch.inference_mode():
        ref_cache = init_kv_cache(cfg, n_global, max_len, dtype=dtype, device=dev)
        rl, _ = llama_prefill(params, torch.as_tensor(prompts, device=dev), ref_cache, cfg)
        ref_logits = [rl[:, -1].float()]
        tok = torch.argmax(rl[:, -1], dim=-1)[:, None]
        ref_toks = [tok]
        for i in range(steps):
            rl, _ = llama_decode_step(params, tok, ref_cache, ctx + i, cfg)
            tok = torch.argmax(rl, dim=-1)[:, None]
            ref_logits.append(rl.float())
            ref_toks.append(tok)
        del ref_cache
        sharded = tp_shard_packed_params(params, mesh, cfg)
        cache = init_kv_cache(_local_cfg(cfg, mesh.shape["tp"]), sl.stop - sl.start, max_len,
                              dtype=dtype, device=dev)
        lg, _ = tp_forward_window(sharded, host_local_batch(prompts[sl], mesh), cache, 0, cfg,
                                  mesh)
        got = [lg[:, -1].float()]
        for i in range(steps):
            lg, _ = tp_decode_step(sharded, ref_toks[i][sl], cache, ctx + i, cfg, mesh)
            got.append(lg.float())
    scale = max(r[sl].abs().max().item() for r in ref_logits)
    bound = 1e-3 if dtype == torch.float32 else 0.1 * scale
    margin_min = 1e-2 if dtype == torch.float32 else bound
    worst, flips = 0.0, 0
    for i, (mine, ref) in enumerate(zip(got, ref_logits)):
        ref = ref[sl]
        d = (mine - ref).abs().max().item()
        worst = max(worst, d)
        if not d < bound:
            raise AssertionError(f"step {i}: logits diverged, max {d:.3g} (bound {bound:.3g})")
        top2 = ref.topk(2, dim=-1).values
        decisive = (top2[:, 0] - top2[:, 1]) >= margin_min
        agree = mine.argmax(-1) == ref.argmax(-1)
        flips += int((~agree).sum())
        if bool((decisive & ~agree).any()):
            raise AssertionError(f"step {i}: a decisive argmax flipped")
    return {"max_logit_diff": worst, "bound": bound, "logit_scale": scale,
            "argmax_flips_within_margin": flips, "rows": (sl.start, sl.stop)}


def _engine_leg(params, cfg, mesh, sizes: Sizes) -> Dict:
    """Leg 3: MultiHostEngine (a tp engine per host) against the
    single-process Engine over the whole stream."""
    from qeft_tpu_torch.parallel.tp_forward import tp_shard_packed_params
    from qeft_tpu_torch.serving import Engine, MultiHostEngine, Request

    rng = np.random.default_rng(7)
    stream = [(i, rng.integers(0, cfg.vocab_size, size=4 + i % 3))
              for i in range(sizes.requests)]
    max_len = 8 + sizes.new_tokens + 8
    dtype = params["embed"].dtype
    mh = MultiHostEngine(tp_shard_packed_params(params, mesh, cfg), cfg, mesh=mesh, max_batch=2,
                         max_len=max_len, burst=2, cache_dtype=dtype)
    mine = [i for i, p in stream
            if mh.submit(Request(request_id=i, prompt=p, max_new_tokens=sizes.new_tokens))]
    if len(mine) != sizes.requests // mesh.shape["dp"]:
        raise AssertionError(f"this host took {mine}")
    got = {r.request_id: list(r.output) for r in mh.run(max_ticks=256)}
    ref_eng = Engine(params, cfg, max_batch=2, max_len=max_len, cache_dtype=dtype,
                     device=mesh.device)
    for i, p in stream:
        ref_eng.submit(Request(request_id=i, prompt=p, max_new_tokens=sizes.new_tokens))
    ref = {r.request_id: list(r.output) for r in ref_eng.run(max_ticks=256)}
    for rid in mine:
        if got[rid] != ref[rid]:
            raise AssertionError(f"request {rid}: multihost {got[rid]} != single-process "
                                 f"{ref[rid]}")
    stats = mh.stats()
    if stats["requests_total"] != sizes.requests or \
            stats["tokens_total"] != sizes.requests * sizes.new_tokens:
        raise AssertionError(f"cluster totals {stats}")
    return {"requests": mine, "outputs": got, "stats": stats}


def dryrun_rank(cfg: LlamaConfig, sizes: Sizes, device: str) -> Dict:
    """One rank of the dry run on ``device`` ("cuda" or "cpu"): the three
    legs; host values only."""
    from qeft_tpu_torch.parallel.multihost import global_mesh
    from qeft_tpu_torch.testing import build_packed_model

    mesh = global_mesh(tp=TP, device=device)
    if mesh.shape["dp"] != HOSTS:
        raise AssertionError(f"mesh {mesh.shape}, expected {HOSTS} hosts")
    dev = mesh.device
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    cfg = dataclasses.replace(cfg, dtype=dtype)
    # every host builds the identical model (one seed), as a pod restores
    # one checkpoint
    params = build_packed_model(cfg, seed=0, g=sizes.group_size, r=sizes.weak, dtype=dtype,
                                device=dev)
    out = {"coords": mesh.coords(), "device": str(dev)}
    _leg(out, "train", dev, lambda: _train_leg(params, cfg, mesh, sizes))
    _leg(out, "decode", dev, lambda: _decode_leg(params, cfg, mesh, sizes))
    _leg(out, "engine", dev, lambda: _engine_leg(params, cfg, mesh, sizes))
    return out


def run(cfg: LlamaConfig = DRYRUN_CFG, sizes: Sizes = Sizes(), device=None):
    """The dry run's ranks on this machine -> each rank's results (a rank
    that fails raises here with its traceback)."""
    from qeft_tpu_torch.parallel.mesh import rank_device
    from qeft_tpu_torch.parallel.multihost import launch_ranks

    kind = rank_device(device, 0).type  # raises without a card unless the CPU is named
    return launch_ranks(dryrun_rank, HOSTS * TP, kind, cfg, sizes, kind)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Multi-host dry run: 2 hosts x tp 2 ranks here.")
    ap.add_argument("--device", default=None, help="default: cuda (required)")
    args = ap.parse_args(argv)
    try:
        ranks = run(device=args.device)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        print("MULTIHOST DRYRUN FAILED")
        return 1
    for rank, res in enumerate(ranks):
        print(f"--- rank {rank} {res['coords']} on {res['device']}: losses "
              f"{[round(x, 4) for x in res['train']['losses']]}; dp-sharded decode max |logit "
              f"diff| {res['decode']['max_logit_diff']:.3g} (bound {res['decode']['bound']:.3g})"
              f"; engine served {res['engine']['stats']['tokens_local']} tokens here of "
              f"{res['engine']['stats']['tokens_total']}, equal to the single-process engine's")
    print("MULTIHOST DRYRUN OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
