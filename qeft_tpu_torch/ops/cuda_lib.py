"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` file has a plain C interface and compiles with ``nvcc``
into its own shared library (``sm_90a``), loaded with ``ctypes``.  The build
runs at first use, all sources at once (one ``nvcc`` each), into
``build/kernels/<hash of sources and flags>/`` at the root of the checkout,
so an edited source rebuilds and an unchanged one is loaded as it is.

Every launch goes through `launch`, which checks the ``cudaError_t`` the C
entry point returns and counts the launch in `launches` under the kernel's
name.  Nothing here falls back to a plain version: a failed build or launch
raises.

`Graph` captures a function as one CUDA graph.  A launch made while a graph
is captured only records the kernel, so the counts its capture added are
taken back out and added again at every replay: `launches` counts kernels
that ran, captured or not.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("qmm.cu", "flash.cu", "decode_attention.cu", "probes.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# launches of each kernel since the last `reset_launches`, counted by
# `launch` after the C entry point returned success
launches: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signature of every entry point: (library, argtypes)
_ENTRY_POINTS = {
    "qgemv_stacked_fused": ("qmm.cu", [
        _P, _P, _P, _P, _P, _P, _P, _P,  # x lnw qweight scales szeros ow res out
        _I, _I, _I, _I, _I, _I,  # layer M K N group_size R
        _F, _I, _P,  # eps one_offset stream
    ]),
    "qgemm": ("qmm.cu", [
        _P, _P, _P, _P, _P, _P, _P, _P,  # x qweight scales szeros ow res out workspace
        _I, _I, _I, _I, _I, _I, _I,  # M K N group_size R bm splits
        _P,  # stream
    ]),
    "qgemm_t": ("qmm.cu", [
        _P, _P, _P, _P, _P, _P,  # g qweight scales szeros tail out
        _I, _I, _I, _I, _I, _I,  # M K N group_size R bm
        _P,  # stream
    ]),
    "flash_window_attention": ("flash.cu", [
        _P, _P, _P, _P, _P,  # q k v pos_array out
        _I, _I, _I, _I, _I, _I, _I,  # B S H Hkv Sk D pos0
        _P,  # stream
    ]),
    "decode_attention": ("decode_attention.cu", [
        _P, _P, _P, _P, _P,  # q k v pos_dev out
        _I, _I, _I, _I, _I, _I,  # B H Hkv S D pos
        _P,  # stream
    ]),
    "decode_attention_int8": ("decode_attention.cu", [
        _P, _P, _P, _P, _P, _P, _P,  # q k v k_scale v_scale pos_dev out
        _I, _I, _I, _I, _I, _I,  # B H Hkv S D pos
        _P,  # stream
    ]),
    "decode_attention_stacked": ("decode_attention.cu", [
        _P, _P, _P, _P, _P, _P, _P, _P, _P,  # q k v k_scale v_scale k_new v_new pos_dev out
        _I, _I, _I, _I, _I, _I, _I, _I,  # L B H Hkv S D layer pos
        _P,  # stream
    ]),
    "qgemv_stacked": ("qmm.cu", [
        _P, _P, _P, _P, _P, _P,  # x qweight scales szeros ow out
        _I, _I, _I, _I, _I, _I,  # layer M K N group_size R
        _P,  # stream
    ]),
    "qgemv": ("qmm.cu", [
        _P, _P, _P, _P, _P, _P, _P,  # x qweight scales szeros ow bias out
        _I, _I, _I, _I, _I,  # M K N group_size R
        _P,  # stream
    ]),
    "qgemv_moe": ("qmm.cu", [
        _P, _P, _P, _P, _P, _P, _P, _P,  # x qweight scales szeros ow counts offsets out
        _I, _I, _I, _I, _I, _I,  # E max_rows K N group_size R
        _P,  # stream
    ]),
    "decode_latent_attention": ("decode_attention.cu", [
        _P, _P, _P, _P,  # q cache pos_dev out
        _I, _I, _I, _I, _I, _I,  # B H S D DV pos
        _F, _P,  # scale stream
    ]),
    "add_one": ("probes.cu", [_P, _P, _I, _P]),  # x y n stream
    "dma_only": ("probes.cu", [
        _P, _P, _P, _P,  # qw out workspace tickets
        _I, _I, _I,  # K8 N rows_per_block
        _P,  # stream
    ]),
    "unpack_only": ("probes.cu", [
        _P, _P, _P, _P,  # qw out workspace tickets
        _I, _I, _I, _I, _I, _I,  # K8 N bn rows_per_block stage_rows stages
        _P,  # stream
    ]),
    "dma_tile": ("probes.cu", [
        _P, _P, _P,  # qw s out
        _I, _I, _I, _I, _I, _I,  # K8 N bn rows_per_block stage_rows stages
        _P,  # stream
    ]),
    "gemv_ablation": ("probes.cu", [
        _P, _P, _P, _P,  # x qw s out
        _I, _I, _I, _I, _I,  # K8 N G bn variant
        _P,  # stream
    ]),
}

# the bf16w variants of K1, K6 and K5 (QEFT_GEMV_F32W=0) take the same arguments
for _name in ("qgemv_stacked_fused", "qgemv_stacked", "qgemv"):
    _ENTRY_POINTS[f"{_name}_bf16w"] = _ENTRY_POINTS[_name]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds = 0.0


def reset_launches() -> None:
    launches.clear()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            h.update((CSRC / name).read_bytes())
    return CSRC.parent.parent / "build" / "kernels" / h.hexdigest()[:16]


def _build_all(out: Path) -> None:
    """Compile every missing library, all nvcc processes started together."""
    nvcc = _nvcc()
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in SOURCES:
        so = out / (Path(src).stem + ".so")
        if so.exists():
            continue
        tmp = out / f"{so.name}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / src)]
        procs.append((so, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for so, tmp, cmd, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{log}")
        else:
            os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))


def load() -> Dict[str, ctypes.CDLL]:
    """Build (first use) and load every kernel library; returns them by source."""
    global build_seconds
    with _lock:
        if not _libs:
            tick = time.perf_counter()
            out = build_dir()
            _build_all(out)
            for src in SOURCES:
                _libs[src] = ctypes.CDLL(str(out / (Path(src).stem + ".so")))
            for name, (src, argtypes) in _ENTRY_POINTS.items():
                fn = getattr(_libs[src], name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            build_seconds = time.perf_counter() - tick
    return _libs


def launch(name: str, *args) -> None:
    """Call C entry point ``name`` on the current stream and count it."""
    src, _ = _ENTRY_POINTS[name]
    fn = getattr(load()[src], name)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
    launches[name] += 1


class Graph:
    """``fn()`` captured once as a CUDA graph on ``stream`` (the caller has
    run it there before, so that lazy set-up -- library handles, workspaces,
    the kernel libraries -- happens outside the capture); `replay` runs it
    and counts its launches.  ``generators``: the ``torch.Generator`` s the
    function draws from, registered so that each replay draws new numbers.

    A host read of a device value inside ``fn`` (``.item()``, ``int()`` of a
    tensor) makes the capture raise; nothing falls back to running ``fn``
    eagerly.  ``output``: what ``fn`` returned at the capture, tensors that
    every replay writes anew."""

    def __init__(self, fn, stream: torch.cuda.Stream, generators=()):
        self.graph = torch.cuda.CUDAGraph()
        self.stream = stream
        for gen in generators:
            self.graph.register_generator_state(gen)
        before = collections.Counter(launches)
        with torch.cuda.stream(stream):
            self.graph.capture_begin()
            try:
                self.output = fn()
            finally:
                self.graph.capture_end()
        self.counts = launches - before  # recorded, not run
        for name, c in self.counts.items():
            launches[name] -= c
            if not launches[name]:
                del launches[name]

    def replay(self, n: int = 1) -> None:
        """``n`` replays on the capture stream, in order, without waiting."""
        with torch.cuda.stream(self.stream):
            for _ in range(n):
                self.graph.replay()
        for name, c in self.counts.items():
            launches[name] += c * n


def ptr(t) -> int:
    """Device pointer of a tensor, or NULL for None."""
    return 0 if t is None else t.data_ptr()


def aligned(t):
    """``t`` contiguous and 16-byte aligned (the kernels read 16-byte
    vectors); a view that is not becomes a copy."""
    if t is None:
        return None
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
