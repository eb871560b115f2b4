"""The kernel calls a traced stretch must hold, worked out from the shapes
and the traffic alone, so a reader can check the trace's count against them
and never guess.  ``run.traced``: {"requests": [(prompt, output, batch)]} of
a decode cell's traced requests, or {"steps": n} of a training cell's."""

from __future__ import annotations

import sys
from typing import Dict, List, Tuple

Call = Tuple[int, int, int]  # (M, K, N)


def decode(run) -> Dict[str, List]:
    """K5 calls of the decode steps, K2 calls of the prefills, and (batch,
    keys) of every decode step of the traced requests.  The first token
    comes from the prefill, so a request of T tokens runs T - 1 steps."""
    d = run.dims
    qgemv, qgemm, steps = [], [], []
    for prompt, output, batch in run.traced["requests"]:
        for _, k, n in d.linears:
            qgemv += [(batch, k, n)] * (d.layers * (output - 1))
            qgemm += [(batch * prompt, k, n)] * d.layers
        steps += [(batch, prompt + i) for i in range(1, output)]
    return {"qgemv": qgemv, "qgemm": qgemm, "steps": steps}


def train(run) -> Dict[str, List]:
    """K2 calls (each linear forward and once more recomputed, remat on) and
    K7 calls (each linear's dx but the first layer's norm-fed ones) of the
    traced steps."""
    d, mix = run.dims, run.mix
    m = mix["batch"] * mix["seq"]
    remat = 2 if mix["optimizer"]["remat"] else 1
    qgemm, qgemm_t = [], []
    for _ in range(run.traced["steps"]):
        for name, k, n in d.linears:
            qgemm += [(m, k, n)] * (remat * d.layers)
            qgemm_t += [(m, k, n)] * (d.layers - (name in d.norm_fed))
    return {"qgemm": qgemm, "qgemm_t": qgemm_t}


def matches(metric: str, want: List, got: List) -> bool:
    """Whether the trace holds exactly the calls expected; says so if not."""
    if len(want) == len(got) and want:
        return True
    print(f"{metric}: expected {len(want)} kernel calls, the trace holds {len(got)}: "
          "left out", file=sys.stderr)
    return False


def seconds(acts) -> float:
    return sum(a.end - a.start for a in acts) / 1e9
