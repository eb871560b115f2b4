"""CLI: weak-column tuning of a packed checkpoint.

    python -m qeft_tpu_torch.run_finetune --load ckpt/llama2_7b_packed \\
        --output_dir runs/wct --max_steps 1000 --batch_size 4 --grad_accum 4

Counterpart of ``qeft_tpu/run_finetune.py`` with the same flags, plus
``--device`` (default: the GPU, which must exist).  Loads a packed
checkpoint, fuses its stages (unless its linears carry their own
``reorder_ids``: such a tree trains unfused), trains only the weak-column
slabs, and writes
``wct_step<N>`` every ``--save_steps``, ``wct_final``, ``metrics.json`` and
the ``completed`` sentinel into ``--output_dir``; a rerun resumes from the
newest ``wct_step<N>``.  The optimizer-state sidecar ``opt_step<N>.pt`` is
the port's own format (``torch.save`` of the AdamW state, the schedule's
step and the accumulation state); the JAX package's ``opt_step<N>.npz``
sidecars are not read.  Resume restores the slabs in f32 from the WCT file.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from qeft_tpu_torch.checkpoint import load_packed, read_wct, save_wct
from qeft_tpu_torch.data.sft import batches, load_sft_examples, mask_and_pad
from qeft_tpu_torch.device import resolve_device
from qeft_tpu_torch.finetune import (
    TrainConfig,
    make_optimizer,
    make_train_step,
    merge_wct,
    split_wct,
    wct_loss,
)
from qeft_tpu_torch.models.registry import get_model_meta
from qeft_tpu_torch.pipeline import fuse_packed_stages, fuse_tensors, per_linear_reorder


def get_last_checkpoint(output_dir: str):
    """-> (path of the newest ``wct_step<N>.npz``, N), ("completed", 0) after
    a finished run, or (None, 0)."""
    if not os.path.isdir(output_dir):
        return None, 0
    if os.path.exists(os.path.join(output_dir, "completed")):
        print("training already finished (completed sentinel found)")
        return "completed", 0
    steps = [int(name[len("wct_step"): -len(".npz")]) for name in os.listdir(output_dir)
             if name.startswith("wct_step") and name.endswith(".npz")]
    if not steps:
        return None, 0
    last = max(steps)
    return os.path.join(output_dir, f"wct_step{last}.npz"), last


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--load", type=str, required=True, help="packed ckpt path")
    parser.add_argument("--device", default=None, help="default: cuda (required)")
    parser.add_argument("--dataset", type=str, default="synthetic",
                        choices=["synthetic", "platypus", "alpaca", "oasst1",
                                 "wikitext", "wikitext2"])
    parser.add_argument("--tokenizer", type=str, default=None)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--max_steps", type=int, default=100)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--grad_accum", type=int, default=1)
    parser.add_argument("--learning_rate", type=float, default=2e-4)
    parser.add_argument("--weight_decay", type=float, default=0.0)
    parser.add_argument("--warmup_ratio", type=float, default=0.03)
    parser.add_argument("--lr_schedule", type=str, default="cosine",
                        choices=["cosine", "constant"])
    parser.add_argument("--max_grad_norm", type=float, default=0.3)
    parser.add_argument("--source_max_len", type=int, default=512)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--save_steps", type=int, default=50)
    parser.add_argument("--log_steps", type=int, default=10)
    parser.add_argument("--nsamples", type=int, default=None)
    parser.add_argument("--no_remat", action="store_true")
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--eval_steps", type=int, default=0,
                        help="eval validation loss every N steps (0 = off)")
    parser.add_argument("--eval_nsamples", type=int, default=32,
                        help="examples held out of training for validation")
    parser.add_argument("--do_mmlu_eval", action="store_true")
    parser.add_argument("--mmlu_eval_steps", type=int, default=0,
                        help="eval every N steps (default: save_steps)")
    parser.add_argument("--mmlu_source", type=str, default="synthetic",
                        help="'synthetic', or a tokenizer dir for the MMLU files")
    parser.add_argument("--mmlu_n", type=int, default=64)
    parser.add_argument("--mmlu_split", type=str, default="validation")
    return parser


def main(argv=None):
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    resume_path, start_step = get_last_checkpoint(args.output_dir)
    if resume_path == "completed":
        return None

    params, cfg, family = load_packed(args.load, device=device)
    meta = get_model_meta(family)
    # stages fuse where they share one input permutation; a tree packed
    # without the global reorder trains unfused, as qeft_tpu trains every tree
    fuse = not per_linear_reorder(params)
    oweights, frozen = split_wct(fuse_packed_stages(params, meta) if fuse else params, meta)
    del params
    if resume_path:
        print(f"resuming from {resume_path} (step {start_step})")
        slabs = read_wct(resume_path)[0]
        slabs = fuse_tensors(slabs, meta) if fuse else slabs
        with torch.no_grad():
            for name, leaves in oweights.items():
                for leaf, w in zip(leaves, slabs[name].unbind(0)):
                    leaf.copy_(w)

    tc = TrainConfig(
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        warmup_ratio=args.warmup_ratio, total_steps=args.max_steps,
        grad_accum=args.grad_accum, max_grad_norm=args.max_grad_norm,
        lr_schedule=args.lr_schedule, remat=not args.no_remat,
    )
    opt = make_optimizer(tc, oweights)
    if resume_path:
        opt_path = os.path.join(args.output_dir, f"opt_step{start_step}.pt")
        if os.path.exists(opt_path):
            opt.load_state_dict(torch.load(opt_path, map_location=device, weights_only=True))
            print(f"restored optimizer state (schedule at step {start_step})")
        else:
            print("WARNING: no optimizer-state sidecar; Adam moments and the "
                  "LR schedule restart from zero")
    step_fn = make_train_step(cfg, opt, remat=tc.remat, family=family)

    examples = load_sft_examples(args.dataset, args.tokenizer, args.nsamples,
                                 cfg.vocab_size, args.seed)
    eval_examples = []
    if args.eval_steps > 0:
        if args.eval_nsamples <= 0:
            raise ValueError("--eval_nsamples must be positive with --eval_steps")
        if len(examples) <= args.eval_nsamples:
            raise ValueError(f"--eval_nsamples {args.eval_nsamples} >= dataset size "
                             f"{len(examples)}; nothing left to train on")
        eval_examples = examples[-args.eval_nsamples:]
        examples = examples[: -args.eval_nsamples]
    data = batches(examples, args.batch_size, args.source_max_len, args.seed,
                   epochs=args.epochs)

    def to_dev(a):
        return torch.as_tensor(a, device=device)

    @torch.no_grad()
    def run_eval(step):
        """Held-out validation loss of the current training model."""
        total, n_seen = 0.0, 0
        for i in range(0, len(eval_examples), args.batch_size):
            chunk = eval_examples[i: i + args.batch_size]  # remainder included
            ids, labels = mask_and_pad(chunk, args.source_max_len, 0, False)
            loss = wct_loss(oweights, frozen, to_dev(ids), to_dev(labels), cfg,
                            remat=False, family=family)
            total += float(loss) * len(chunk)
            n_seen += len(chunk)
        eval_loss = total / n_seen
        print(f"step {step}  eval-loss {eval_loss:.4f} (n={n_seen})")
        return {"step": step, "eval_loss": eval_loss}

    mmlu_examples = None
    if args.do_mmlu_eval:
        from qeft_tpu_torch.eval_mc import load_mmlu_examples, synthetic_mc_examples

        if args.mmlu_source == "synthetic":
            mmlu_examples = synthetic_mc_examples(args.mmlu_n, cfg.vocab_size, args.seed)
        else:
            mmlu_examples = load_mmlu_examples(args.mmlu_source, split=args.mmlu_split,
                                               n=args.mmlu_n)

    def run_mmlu(step):
        """Multiple-choice accuracy of the current training model, served."""
        from qeft_tpu_torch.eval_mc import evaluate_mc

        res = evaluate_mc(merge_wct(oweights, frozen, stack=True), mmlu_examples, cfg,
                          family, device=device)
        print(f"step {step}  mmlu-eval accuracy {res['accuracy']:.4f} (n={res['n']})")
        return {"step": step, "mmlu_accuracy": res["accuracy"], "mmlu_n": res["n"]}

    def write_metrics():
        with open(os.path.join(args.output_dir, "metrics.json"), "w") as f:
            json.dump(metrics, f, indent=1)

    mmlu_every = args.mmlu_eval_steps or args.save_steps
    metrics = []
    if start_step:
        mpath = os.path.join(args.output_dir, "metrics.json")
        if os.path.exists(mpath):
            with open(mpath) as f:  # entries past the checkpoint are redone
                metrics = [m for m in json.load(f) if m["step"] <= start_step]
        for _ in range(start_step):  # data position follows the step counter
            next(data, None)
    t0 = time.time()
    step = start_step
    for batch in data:
        if step >= args.max_steps:
            break
        loss = step_fn(oweights, frozen, to_dev(batch["input_ids"]), to_dev(batch["labels"]))
        step += 1
        if step % args.log_steps == 0 or step == 1:
            loss_f = float(loss)
            rate = (step - start_step) / max(time.time() - t0, 1e-9)
            print(f"step {step}/{args.max_steps}  loss {loss_f:.4f}  ({rate:.2f} it/s)")
            metrics.append({"step": step, "loss": loss_f})
        if step % args.save_steps == 0:
            save_wct(os.path.join(args.output_dir, f"wct_step{step}"), oweights, args.load)
            torch.save(opt.state_dict(), os.path.join(args.output_dir, f"opt_step{step}.pt"))
            write_metrics()  # crash-durable
        if mmlu_examples is not None and step % mmlu_every == 0:
            metrics.append(run_mmlu(step))
        if args.eval_steps > 0 and step % args.eval_steps == 0:
            metrics.append(run_eval(step))

    if mmlu_examples is not None:
        metrics.append(run_mmlu(step))
    if args.eval_steps > 0 and step % args.eval_steps != 0:
        metrics.append(run_eval(step))
    save_wct(os.path.join(args.output_dir, "wct_final"), oweights, args.load)
    write_metrics()
    with open(os.path.join(args.output_dir, "completed"), "w") as f:
        f.write("done\n")
    print(f"WCT checkpoint -> {args.output_dir}/wct_final.npz")
    return metrics


if __name__ == "__main__":
    main()
