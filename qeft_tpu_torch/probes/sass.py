"""The instructions a word of a kernel's hot loop, read from the SASS of the
built kernel library (``cuobjdump -sass``), and the issue bound they set.

A loop is a backward branch and the instructions from its target to it.  The
hot loop of a kernel is, among the innermost loops that hold an instruction
matching ``marker``, the one that loads the most bytes from shared memory
(``LDS``); its words are those bytes over 4.  The issue bound is the time
the SMs take to issue those instructions for every word of a call: each SM
issues at most 4 warp-instructions a clock (one a scheduler), 32 lanes
each, at the card's highest SM clock.  The integer bound counts only the
loop's 32-bit logic, shift and add instructions (LOP3, SHF, IADD3), which
an SM of compute capability 9.0 executes at 64 lanes a clock, half the
issue rate (the CUDA C++ Programming Guide's arithmetic throughput table).

    python -m qeft_tpu_torch.probes.sass   # unpack_only's hot loop and bounds
"""

from __future__ import annotations

import collections
import json
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from qeft_tpu_torch.ops import cuda_lib

ISSUE_PER_CLOCK = 4  # warp-instructions an SM issues a clock (4 schedulers)
LANES = 32
INT_LANES_PER_CLOCK = 64  # 32-bit integer add, logic and shift results an SM a clock
INT_OPS = ("LOP3", "SHF", "IADD3")

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_BRANCH = re.compile(r"\bBRA(?:\.\w+)*\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")


def _tool(name: str) -> str:
    for cand in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError(f"{name} not found: the SASS cannot be read")


def parse_sass(text: str, kernel: str) -> List[Tuple[int, str, Optional[int]]]:
    """(address, instruction, branch target or None) of the one function of a
    ``cuobjdump -sass`` listing whose name holds ``kernel``."""
    funcs = re.split(r"\n\s*Function : ", text)[1:]
    found = [f for f in funcs if kernel in f.split("\n", 1)[0]]
    if len(found) != 1:
        raise RuntimeError(f"the listing holds {len(found)} functions named like {kernel}")
    insns, labels, pending = [], {}, []
    for line in found[0].splitlines():
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            labels.update((lab, addr) for lab in pending)
            pending = []
            insns.append((addr, m.group(2)))

    def target(insn):
        m = _BRANCH.search(insn)
        if not m:
            return None
        return labels[m.group(1)] if m.group(1) else int(m.group(2), 16)

    return [(a, s, target(s)) for a, s in insns]


def kernel_sass(lib: Path, kernel: str) -> List[Tuple[int, str, Optional[int]]]:
    """`parse_sass` of the built library ``lib``."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return parse_sass(text, kernel)


def _opcode(insn: str) -> str:
    body = re.sub(r"^@!?U?P\w+\s+", "", insn)
    return body.split()[0] if body else ""


def _lds_bytes(op: str) -> int:
    if not op.startswith("LDS"):
        return 0
    return 16 if ".128" in op else 8 if ".64" in op else 4


def hot_loop(insns: List[Tuple[int, str, Optional[int]]], marker: str) -> Dict:
    """The hot loop (see the module's note): its bounds, instruction count
    (NOPs left out), words, instructions a word and opcode histogram."""
    loops = [(t, addr, [s for a, s, _ in insns if t <= a <= addr])
             for addr, _, t in insns if t is not None and t <= addr]
    pat = re.compile(marker)
    marked = [lp for lp in loops if any(pat.search(s) for s in lp[2])]
    inner = [lp for lp in marked
             if not any(o is not lp and lp[0] <= o[0] and o[1] <= lp[1] for o in marked)]
    if not inner:
        raise RuntimeError(f"no loop of the kernel holds an instruction matching {marker!r}")
    best = max(inner, key=lambda lp: sum(_lds_bytes(_opcode(s)) for s in lp[2]))
    ops = [_opcode(s) for s in best[2] if _opcode(s) != "NOP"]
    words = sum(_lds_bytes(op) for op in ops) / 4
    if words == 0:
        raise RuntimeError("the hot loop loads no words from shared memory")
    hist = collections.Counter(op.split(".")[0] for op in ops)
    return {"start": best[0], "end": best[1], "instructions": len(ops), "words": words,
            "per_word": len(ops) / words,
            "int_per_word": sum(hist[op] for op in INT_OPS) / words,
            "opcodes": dict(hist.most_common())}


def max_sm_clock_hz(device) -> float:
    """The highest SM clock of the CUDA ``device`` (``nvidia-smi
    clocks.max.sm`` of the card with its UUID)."""
    uuid = f"GPU-{torch.cuda.get_device_properties(device).uuid}"
    out = subprocess.run(["nvidia-smi", "-i", uuid, "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def issue_bound_ms(per_word: float, words: int, sms: int, clock_hz: float) -> float:
    """The least time ``words`` take to issue at ``per_word`` instructions
    a word: per_word x words / 32 lanes over 4 x ``sms`` x the clock."""
    return per_word * words / LANES / (ISSUE_PER_CLOCK * sms * clock_hz) * 1e3


def int_bound_ms(int_per_word: float, words: int, sms: int, clock_hz: float) -> float:
    """The least time of ``int_per_word`` 32-bit integer instructions a word
    on the integer pipes: 64 lanes a clock an SM."""
    return int_per_word * words / (INT_LANES_PER_CLOCK * sms * clock_hz) * 1e3


def unpack_issue(words: int, device) -> Dict:
    """`unpack_only`'s hot loop in the built ``probes.so`` (its nibble-pair
    mask marks it), and the issue and integer bounds of ``words`` words on
    the CUDA ``device``."""
    loop = hot_loop(kernel_sass(cuda_lib.build_dir() / "probes.so", "unpack_ring_kernel"),
                    r"0xf000f")
    sms, clock = cuda_lib.sm_count(device), max_sm_clock_hz(device)
    loop.update(clock_hz=clock, issue_bound_ms=issue_bound_ms(loop["per_word"], words, sms, clock),
                int_bound_ms=int_bound_ms(loop["int_per_word"], words, sms, clock))
    return loop


def main() -> Dict:
    """`unpack_issue` at P2's shape on the first card, as one JSON line."""
    from qeft_tpu_torch.probes import dma  # dma reads its bounds from here

    cuda_lib.load()
    res = unpack_issue(dma.K8 * dma.N, torch.device("cuda"))
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
