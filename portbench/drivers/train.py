"""Training cells: weak-column tuning steps back to back through
``qeft_tpu_torch.finetune.make_train_step``.

Set-up builds one training object (the packed model split into its f32
slabs and the frozen rest, AdamW under the schedule and the clipping of the
mix) and drives it through the mix's first ``check.steps`` steps, with the
window's own call and feed, on rows that all differ: those steps are the
warm-up and what the check holds against the reference.  It reads the
program's numbers as it goes: each step's loss, each slab's first gradient
as the optimizer got it (its first moment after one step over 1 - beta1),
and each slab's change after the last of those steps.  The same object then
runs the window; a traced run profiles the mix's ``trace`` stretch of
steps, synchronised before and after."""

from __future__ import annotations

import time
from typing import Dict

import torch

from portbench import program, traffic, weights
from portbench.trace import Tracer, reduce, span


def optimizer_config(mix: Dict):
    from qeft_tpu_torch.finetune import TrainConfig

    o = mix["optimizer"]
    return TrainConfig(learning_rate=o["learning_rate"], weight_decay=o["weight_decay"],
                       warmup_ratio=o["warmup_ratio"], total_steps=o["total_steps"],
                       max_grad_norm=o["max_grad_norm"], lr_schedule=o["lr_schedule"],
                       remat=o["remat"])


def slab_norms(leaves: Dict[str, list], fn) -> Dict[str, float]:
    """{"<linear>.<layer>": norm of fn(leaf)} over every slab."""
    return {f"{name}.{l}": float(torch.linalg.vector_norm(fn(name, l, t).float()))
            for name, ts in leaves.items() for l, t in enumerate(ts)}


def run(ctx) -> None:
    from qeft_tpu_torch.finetune import make_optimizer, make_train_step, split_wct

    mix, dims, dev = ctx.mix, ctx.dims, ctx.device
    tree = program.tree(dims, weights.make(dims, ctx.seed, dev))
    oweights, frozen = split_wct(tree)
    del tree  # the packed model's bf16 slabs go; the f32 leaves are the program's copies
    tc = optimizer_config(mix)
    optim = make_optimizer(tc, oweights)
    step = make_train_step(program.config(dims), optim, remat=tc.remat,
                           family=program.port_family(dims))
    ids, labels = traffic.train_rows(mix, ctx.seed, mix["max_steps"], dims.vocab)
    ids, labels = torch.as_tensor(ids, device=dev), torch.as_tensor(labels, device=dev)
    beta1 = mix["optimizer"]["betas"][0]

    n_check = mix["check"]["steps"]
    losses = []
    for i in range(n_check):
        with span("step", i):
            losses.append(step(oweights, frozen, ids[i], labels[i]))
        if i == 0:
            state = optim.optimizer.state
            ctx.program_numbers["grad1"] = slab_norms(
                oweights, lambda n, l, t: state[t]["exp_avg"] / (1 - beta1))
    start = {name: weights.slab(dims, ctx.seed, name, dev) for name in oweights}
    ctx.program_numbers["change"] = slab_norms(
        oweights, lambda n, l, t: t.detach() - start[n][l].float())
    del start
    ctx.program_numbers["losses"] = [float(x) for x in losses]
    ctx.check_rows = (ids[:n_check].clone(), labels[:n_check].clone())
    ctx.mark_setup()

    at = mix.get("trace", {})
    first_traced = n_check + at.get("skip", 1)
    last_traced = first_traced + at.get("steps", 1) - 1
    tracer = Tracer() if ctx.tracing else None
    t0 = time.perf_counter()
    i = n_check
    while time.perf_counter() - t0 < ctx.seconds and i < ids.shape[0]:
        if tracer is not None and i == first_traced:
            tracer.start()
        with span("step", i):
            step(oweights, frozen, ids[i], labels[i])
        if tracer is not None and i == last_traced:
            ctx.raw_trace = tracer.stop()
        i += 1
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ctx.window_s = time.perf_counter() - t0
    ctx.steps = i - n_check
    ctx.note_peak()
    ctx.traced = {"steps": at.get("steps", 1)}
    if ctx.raw_trace is not None:
        ctx.trace = reduce(ctx.raw_trace)
        ctx.raw_trace = None
