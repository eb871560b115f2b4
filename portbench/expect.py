"""The kernel calls a traced stretch must hold, worked out from the shapes
and the traffic alone, so a reader can check the trace's count against them
and never guess.  ``run.traced``: {"requests": [(prompt, output, batch)]} of
a decode cell's traced requests, or {"steps": n} of a training cell's."""

from __future__ import annotations

import sys
from typing import Dict, List, Tuple

from portbench.families import family

Call = Tuple[int, int, int, int, int, bool]  # (M, K, N, g, r, bias): a call's cost inputs


def decode(run) -> Dict[str, List]:
    """{"qgemv": K5 calls of the decode steps, "qgemm": K2 calls of the
    prefills, "steps": every decode step of the traced requests, each a
    tuple `costs.decode_step` takes}: the family's ``expect_decode``."""
    return family(run.dims.family).expect_decode(run)


def train(run) -> Dict[str, List]:
    """{"qgemm": K2 calls, "qgemm_t": K7 calls} of the traced WCT steps: the
    family's ``expect_train``."""
    return family(run.dims.family).expect_train(run)


def matches(metric: str, want: List, got: List) -> bool:
    """Whether the trace holds exactly the calls expected; says so if not."""
    if len(want) == len(got) and want:
        return True
    print(f"{metric}: expected {len(want)} kernel calls, the trace holds {len(got)}: "
          "left out", file=sys.stderr)
    return False


def seconds(acts) -> float:
    return sum(a.end - a.start for a in acts) / 1e9
