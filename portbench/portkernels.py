"""The names of the port's own kernels, read from its sources: every
``__global__`` function of ``qeft_tpu_torch/csrc`` and every
``@triton.jit`` function of the package.  A kernel added to the port is
counted as its own with no edit here."""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path
from typing import Optional

NAME = re.compile(r"(\w+)\s*\(")
TRITON = re.compile(r"@triton\.jit[^\n]*\n\s*def\s+(\w+)")


def _globals(text: str):
    """Names of the ``__global__`` functions of a CUDA source."""
    out = []
    for part in text.split("__global__")[1:]:
        head = part.split("{", 1)[0]
        while "__launch_bounds__" in head:  # drop it and its balanced argument list
            i = head.index("__launch_bounds__")
            j, depth = head.index("(", i), 0
            for j in range(j, len(head)):
                depth += {"(": 1, ")": -1}.get(head[j], 0)
                if depth == 0:
                    break
            head = head[:i] + head[j + 1:]
        m = NAME.search(head)
        if m:
            out.append(m.group(1))
    return out


def names():
    spec = importlib.util.find_spec("qeft_tpu_torch")
    if spec is None or spec.origin is None:
        return []
    root = Path(spec.origin).parent
    found = set()
    for f in root.rglob("*"):
        if f.suffix in (".cu", ".cuh"):
            found.update(_globals(f.read_text()))
        elif f.suffix == ".py":
            found.update(TRITON.findall(f.read_text()))
    return sorted(found)


def pattern() -> Optional[str]:
    """A regex matching a trace name of any of the port's kernels."""
    n = names()
    return r"\b(" + "|".join(map(re.escape, n)) + r")\b" if n else None
