"""The readings a cell's limits are set from, on the card at the cell's own
size, all seeds in one process:

    python3 -m portbench.control --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 --out chiprun_out/control-<cell>.json

For every seed the program runs as a run does and the cell's numbers are
read against the f32 reference: the lower readings.  For each control seed
the same numbers are read of the reference computed in float8
(`reference.common.FP8`), the precision below the configuration's bfloat16,
put in the program's place: the upper readings.  A training cell also reads
the planted fault of a step that leaves half its batch out.

Decode cells serve, per seed, the mix's longest request and as many more
drawn from the seed as a run checks (``check.requests``); training cells run
set-up's checked steps and no window.  The benchmark's runs never run this."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import check, run, traffic
from portbench.drivers import decode
from portbench.reference import common
from portbench.seeds import derive


def decode_readings(ctx, control: bool):
    order = traffic.walk(ctx.mix, ctx.seed)
    longest = max(order, key=lambda po: po[0] + po[1])
    rng = np.random.default_rng(derive(ctx.seed, "control"))
    k = ctx.mix["check"]["requests"]
    pairs = [longest] + [order[int(j)] for j in rng.choice(len(order), size=k - 1, replace=False)]
    model = decode.build(ctx)
    served = decode.Served()
    decode.serve(ctx, model, pairs, lambda i: i >= len(pairs), served)
    del model
    ctx.requests = served.requests
    ctx.served_tokens = [t.cpu() for t in served.tokens]
    del served
    torch.cuda.empty_cache()
    out = check.decode(ctx, control=control)
    return {"program": {"gap": out["gap"]},
            **({"control": {"gap": out["control_gap"]}} if control else {})}


def train_readings(ctx, control: bool):
    from portbench.drivers import train

    ctx.seconds = 0.0
    train.run(ctx)
    torch.cuda.empty_cache()
    out = {"program": check.train(ctx)}
    if control:
        out["control"] = check.train_planted(ctx, ar=common.FP8)
        out["half_batch"] = check.train_planted(ctx, half_batch=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    bench = run.load_json(Path.cwd() / "BENCHMARK.json")
    run.cache_env(Path.cwd())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg = run.load_json(run.find("configs", cell["config"]))
    mix = run.load_json(run.find("traffic", cell["traffic"]))
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    seeds += [s for s in sorted(controls) if s not in seeds]
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        ctx = run.Ctx(cfg, mix, seed, 0.0, False, torch.device("cuda", 0))
        reader = decode_readings if mix["kind"] == "decode" else train_readings
        row = {"seed": seed, **reader(ctx, seed in controls),
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del ctx
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"workload": args.workload, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
