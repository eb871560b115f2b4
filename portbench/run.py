"""One run of one cell: ``python3 -m portbench --workload <name> --seed <n>
--seconds <s> --trace <0|1>``, from the root of a checkout.

The cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``configs/<name>.json``) and a traffic mix (``traffic/<name>.json``), whose
``kind`` names the driver (``drivers/<kind>.py``); its limits are in
``cells/<cell>.json``.  The driver builds the program's model on the card
from the seed, warms up, and runs the window; `check` holds what the window
produced against the reference; each metric the cell reports is read by its
own reader (``metrics/<metric>.py``).  The last line of standard output is
one JSON object; the numbers compared, each beside its limit, close both
standard error and that object.

Exit codes: 0 a result was printed (``correct`` may be false); 2 no card,
too few cards, or an unknown cell; 3 a traced run recorded no trace; 4 JAX
or the JAX package was loaded."""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

_IMPORTED = time.monotonic()
FORBIDDEN = ("jax", "jaxlib", "flax", "qeft_tpu")  # top-level module names, compared whole
HERE = Path(__file__).resolve().parent


def process_age() -> float:
    """Seconds since this process started (``/proc/self/stat`` against the
    boot clock), or since this module was imported where that cannot be read."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - started
    except (OSError, ValueError, IndexError, AttributeError):
        return time.monotonic() - _IMPORTED


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (``qeft_tpu_torch`` is not ``qeft_tpu``)."""
    return sorted({name for name in sys.modules if name.split(".", 1)[0] in FORBIDDEN})


def load_json(path: Path) -> Dict:
    return json.loads(path.read_text())


def find(folder: str, name: str, suffix: str = ".json", root: Path = HERE) -> Path:
    """The file of ``name`` in ``folder`` (configs, traffic, cells, metrics):
    a new one is found by its name, with no list to edit."""
    path = root / folder / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"{folder}/{name}{suffix} is not in {root}")
    return path


def load_reader(name: str, root: Path = HERE):
    """``metrics/<name>.py``'s module (names hold dots, so it is loaded by path)."""
    path = find("metrics", name, ".py", root)
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics this cell reports: its end-to-end ones untraced, its
    per-layer ones traced.  A metric without ``workloads`` belongs to every
    cell (a per-layer one: to every cell reporting the metric it moves)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m["workloads"] or ("workloads" not in m and m["moves"] in moved)]


class Ctx:
    """One run's inputs and what its driver records; the metric readers read
    it once the run is over (``trace``: the reduced trace of a traced run)."""

    def __init__(self, cfg: Dict, mix: Dict, seed: int, seconds: float, tracing: bool, device):
        from portbench import shapes

        self.mix = mix
        self.dims = shapes.dims(cfg)
        self.seed, self.seconds, self.tracing, self.device = seed, seconds, tracing, device
        self.setup_s = 0.0
        self.window_s = 0.0
        self.peak_bytes = 0
        self.requests: List[Dict] = []
        self.served_tokens: List = []
        self.steps = 0
        self.traced: Dict = {}
        self.trace = None
        self.raw_trace = None
        self.program_numbers: Dict = {}
        self.reference_numbers: Dict = {}
        self.check_rows = None
        self.peaks = None

    def mark_setup(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.setup_s = process_age()

    def note_peak(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize()
            self.peak_bytes = torch.cuda.max_memory_allocated(self.device)


def execute(bench: Dict, cell_name: str, seed: int, seconds: float, trace: bool,
            device, files: Optional[Dict] = None) -> Dict:
    """Drive one run of ``cell_name`` on ``device`` (a ``torch.device``)
    and return its result object; the card's presence is not checked.
    ``files``: {"config", "traffic", "cell"} dicts in place of the files
    the cell names (the tests' small sizes)."""
    import torch

    from portbench import check, costs

    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    files = files or {}
    cfg = files.get("config") or load_json(find("configs", cell["config"]))
    mix = files.get("traffic") or load_json(find("traffic", cell["traffic"]))
    limits = (files.get("cell") or load_json(find("cells", cell_name)))["limits"]
    ctx = Ctx(cfg, mix, seed, seconds, trace, device)
    kind = "gpu" if device.type == "cuda" else device.type
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    ctx.peaks = costs.peaks(name)
    driver = importlib.import_module(f"portbench.drivers.{mix['kind']}")
    driver.run(ctx)
    numbers = check.run(ctx)
    metrics = {}
    for m in cell_metrics(bench, cell_name, trace):
        value = load_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
    result = {"correct": correct,
              "attempted": len(ctx.requests) if mix["kind"] == "decode" else ctx.steps,
              "failed": 0, "metrics": metrics,
              "device": {"platform": kind, "kind": name, "count": 1,
                         "memory_peak_bytes": ctx.peak_bytes}}
    if ctx.trace is not None:
        from portbench.trace import breakdown

        tr = ctx.trace
        result["device"]["busy_s"] = tr.busy_ns / 1e9
        result["device"]["window_s"] = tr.window_ns / 1e9
        result["breakdown"] = breakdown(tr)
        result["trace_notes"] = tr.notes
    result["check"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return result


def parse(argv: Optional[List[str]]):
    p = argparse.ArgumentParser(prog="python3 -m portbench", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_env(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    port builds its kernels into ``build/kernels/<hash>`` there itself); no
    library that loads JAX by itself; one CPU thread for torch's host ops.
    Set before torch is imported."""
    cache = root / "build" / "portbench-cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):  # one host thread drives the card
        os.environ[var] = "1"


def main(argv: Optional[List[str]] = None) -> int:
    args = parse(argv)
    root = Path.cwd()
    bench_file = root / "BENCHMARK.json"
    if not bench_file.exists():
        print(f"no BENCHMARK.json in {root}", file=sys.stderr)
        return 2
    bench = load_json(bench_file)
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    cache_env(root)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    if importlib.util.find_spec("qeft_tpu_torch") is None:
        print("the program (qeft_tpu_torch) is not in this checkout", file=sys.stderr)
        return 2
    result = execute(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0))
    if args.trace and "busy_s" not in result["device"]:
        print("the traced run recorded no trace", file=sys.stderr)
        return 3
    found = forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
