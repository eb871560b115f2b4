"""The plans of the bulk-copy ring swept on the card: P3 (`dma2.dma_tile`) at
bn 256, 512 and 1024 and P2's `dma.unpack_only` at its bn 512, over blocks an
SM, stage bytes and ring bytes (`common.stream_plan`), each plan held exact
against the plain version and timed hot and cold at the scripts' shape
[1376, 4096], beside `dma.dma_only` (the register stream).  The defaults of
`common.stream_plan` (P3) and `dma.UNPACK_PLAN` were chosen from it.

    python -m qeft_tpu_torch.probes.ring_sweep [--device cpu] [--out FILE]
"""

from __future__ import annotations

import dataclasses
import itertools
import json

import torch

from qeft_tpu_torch.ops import cuda_lib
from qeft_tpu_torch.probes import common, dma, dma2

BLOCKS_PER_SM = (1, 2, 3, 4)
STAGE_BYTES = (8 << 10, 16 << 10, 32 << 10, 64 << 10)
RING_BYTES = (64 << 10, None)  # None: the whole block's rows, no slot reused
SMEM_PER_SM = 228 << 10  # an SM's shared memory, its blocks' together


def launch(name: str, qw: torch.Tensor, s: torch.Tensor, plan: common.StreamPlan) -> torch.Tensor:
    """One launch of ``name`` (``dma_tile`` or ``unpack_only``) under
    ``plan``, in place of the plan its wrapper would take."""
    ptr = cuda_lib.ptr
    out = torch.empty(8, plan.n, dtype=torch.float32, device=qw.device)
    ring = (plan.k8, plan.n, plan.bn, plan.rows_per_block, plan.stage_rows, plan.stages)
    if name == "dma_tile":
        cuda_lib.launch(name, ptr(qw), ptr(s), ptr(out), *ring)
    else:
        cuda_lib.launch(name, ptr(qw), ptr(out),
                        ptr(common.workspace(qw.device, plan.n, torch.int32)),
                        ptr(common.tickets(qw.device, plan.tiles)), *ring)
    return out


def plans(k8: int, n: int, bn: int, sms: int):
    """Every plan of the sweep whose blocks an SM fit its shared memory
    together, with its (blocks an SM, stage bytes, ring bytes)."""
    for bps, stage, ring in itertools.product(BLOCKS_PER_SM, STAGE_BYTES, RING_BYTES):
        try:
            plan = common.stream_plan(k8, n, bn, sms, bps, stage, ring or common.SMEM_LIMIT)
        except ValueError:
            continue
        resident = min(bps, -(-plan.tiles * plan.splits // sms))
        if ring is None and plan.stages * plan.stage_rows < plan.rows_per_block:
            continue
        if plan.smem * resident <= SMEM_PER_SM:
            yield plan, dict(blocks_per_sm=bps, stage_bytes=stage, ring_bytes=ring or "all")


def measure(device, k8: int = dma.K8, n: int = dma.N, seed: int = 0) -> dict:
    qw = dma.random_words(k8, n, seed, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    s = torch.randn(8, n, generator=gen, device=device)
    copies = [qw] + [qw.clone() for _ in range(common.n_copies(qw.numel() * 4) - 1)]
    sms = cuda_lib.sm_count(device)
    rows = []
    cases = [("dma_tile", bn, dma2.dma_tile_plain(qw, s)) for bn in dma2.BNS]
    cases.append(("unpack_only", dma.unpack_bn(n), dma.unpack_only_plain(qw)))
    for name, bn, want in cases:
        for plan, knobs in plans(k8, n, bn, sms):
            if not torch.equal(launch(name, qw, s, plan), want):
                raise AssertionError(f"{name} differs from its plain version under {plan}")
            t = common.hot_cold(lambda w, plan=plan: launch(name, w, s, plan), copies, 10, 5)
            rows.append({"kernel": name, "bn": bn, **knobs, **dataclasses.asdict(plan),
                         "smem": plan.smem, "hot_ms": t["hot_ms"], "cold_ms": t["cold_ms"]})
    return {"shape": [k8, n], "dma_only": common.hot_cold(dma.dma_only, copies, 10, 5),
            "plans": rows}


def main(argv=None) -> dict:
    def flags(ap):
        ap.add_argument("--out", default=None, help="write the whole sweep here as JSON")

    args, device = common.parse_device(argv, __doc__.splitlines()[0], flags)
    if device.type != "cuda":
        res = {"device": "cpu", "plans": len(list(plans(dma.K8, dma.N, 512, 132))),
               "times": "not measured"}
        common.report(res)
        return res
    res = measure(device)
    for r in res["plans"]:
        print(f"{r['kernel']} bn={r['bn']}: {r['blocks_per_sm']} blocks an SM, stages of "
              f"{r['stage_bytes'] >> 10} KB, ring {r['ring_bytes']}: {r['rows_per_block']} rows a "
              f"block, {r['stage_rows']} a stage, {r['stages']} slots, grid {r['tiles']} x "
              f"{r['splits']}: hot {r['hot_ms'] * 1e3:.2f} us, cold {r['cold_ms'] * 1e3:.2f} us",
              flush=True)
    t = res["dma_only"]
    print(f"dma_only: hot {t['hot_ms'] * 1e3:.2f} us, cold {t['cold_ms'] * 1e3:.2f} us", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f)
    res["device"] = torch.cuda.get_device_name(device)
    common.report({k: v for k, v in res.items() if k != "plans"})
    return res


if __name__ == "__main__":
    main()
