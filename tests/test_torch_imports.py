"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points refuse to run on the CPU unless the caller names it."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import qeft_tpu_torch
from qeft_tpu_torch import main as torch_main
from qeft_tpu_torch import run_benchmark, run_finetune
from qeft_tpu_torch import speculative as spec
from qeft_tpu_torch.checkpoint import load_model, load_packed, load_wct, save_packed
from qeft_tpu_torch.eval_mc import evaluate_mc, synthetic_mc_examples
from qeft_tpu_torch.eval import eval_ppl
from qeft_tpu_torch.generate import generate
from qeft_tpu_torch.models import bloom, falcon, opt, phi
from qeft_tpu_torch.models.api import get_model_api
from qeft_tpu_torch.models.llama import LLAMA_PRESETS, init_kv_cache, init_params
from qeft_tpu_torch.serving import Engine, SpecEngine, measure_engine_throughput
from qeft_tpu_torch.testing import build_packed_model

PKG = Path(qeft_tpu_torch.__file__).parent
BANNED = ("jax", "jaxlib", "ml_dtypes", "qeft_tpu")


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield path, ".".join(parts)


def test_no_import_line_names_jax_or_the_jax_package():
    for path, _ in _modules():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in BANNED, f"{path}: imports {name}"


def test_every_module_imports_with_jax_blocked():
    mods = [m for _, m in _modules()]
    code = "\n".join([
        "import importlib, sys",
        *[f"sys.modules[{b!r}] = None" for b in BANNED],
        f"for m in {mods!r}:",
        "    importlib.import_module(m)",
        f"assert not any(b in sys.modules and sys.modules[b] is not None for b in {BANNED!r})",
        "print('ok', len(" + repr(mods) + "))",
    ])
    env = {**os.environ, "PYTHONPATH": str(PKG.parent)}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_entry_points_raise_without_a_gpu_unless_cpu_is_named(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LLAMA_PRESETS["tiny"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_packed_model(cfg, g=64, r=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_packed(str(tmp_path / "absent"))
    params = build_packed_model(cfg, g=64, r=8, dtype=torch.float32, device="cpu")
    cache = {"k": torch.zeros(2, 1, 2, 8, 64), "v": torch.zeros(2, 1, 2, 8, 64)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(params, torch.zeros(1, 4, dtype=torch.int64), cache, cfg, 2)
    tokens, _ = generate(params, torch.zeros(1, 4, dtype=torch.int64), cache, cfg, 2, device="cpu")
    assert tokens.shape == (1, 2)
    stream = torch.zeros(64, dtype=torch.int64).numpy()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_ppl(params, stream, cfg, seqlen=16, max_windows=1)
    assert eval_ppl(params, stream, cfg, seqlen=16, max_windows=1, device="cpu") > 0
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_main.main(["--load", str(tmp_path / "absent"), "--eval"])


@pytest.mark.parametrize("value,raises", [("1", True), ("true", True), ("yes", True),
                                          ("0", False), ("", False), ("false", False)])
def test_main_refuses_quant_lmhead_it_cannot_honour(monkeypatch, tmp_path, value, raises):
    """``QEFT_QUANT_LMHEAD`` set as qeft_tpu/main.py reads it (any value but
    "0", "" and "false") asks for an RTN int4 lm_head, which the port does
    not have yet: main raises before it reads the checkpoint, naming A6."""
    monkeypatch.setenv("QEFT_QUANT_LMHEAD", value)
    argv = ["--load", str(tmp_path / "absent"), "--device", "cpu", "--eval"]
    if raises:
        with pytest.raises(NotImplementedError, match="A6"):
            torch_main.main(argv)
    else:  # past the check: the absent checkpoint is what fails
        with pytest.raises(FileNotFoundError):
            torch_main.main(argv)


def test_training_entry_points_raise_without_a_gpu_unless_cpu_is_named(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LLAMA_PRESETS["tiny"]
    params = build_packed_model(cfg, g=64, r=8, dtype=torch.float32, device="cpu")
    base = str(tmp_path / "base")
    save_packed(base, params, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_finetune.main(["--load", base, "--output_dir", str(tmp_path / "run")])
    assert not (tmp_path / "run").exists()
    for load in (load_packed, load_model):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load(base)
    run_finetune.main(["--load", base, "--output_dir", str(tmp_path / "run"), "--device",
                       "cpu", "--max_steps", "2", "--batch_size", "1", "--source_max_len",
                       "16", "--nsamples", "4"])
    wct = str(tmp_path / "run" / "wct_final")
    for load in (load_wct, load_model):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load(wct)
    tuned, cfg2, family = load_model(wct, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_mc(tuned, synthetic_mc_examples(2, cfg.vocab_size), cfg2, family)
    assert evaluate_mc(tuned, synthetic_mc_examples(2, cfg.vocab_size), cfg2, family,
                       device="cpu")["n"] == 2


def test_serving_entry_points_raise_without_a_gpu_unless_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LLAMA_PRESETS["tiny"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    params = build_packed_model(cfg, g=64, r=8, dtype=torch.float32, device="cpu")
    draft, dcfg = spec.layer_sliced_draft(params, cfg, 1)
    prompt = torch.zeros(1, 4, dtype=torch.int64)

    def caches():
        return (init_kv_cache(cfg, 1, 16, dtype=torch.float32),
                init_kv_cache(dcfg, 1, 16, dtype=torch.float32))

    calls = [
        lambda **kw: Engine(params, cfg, max_batch=1, max_len=16, **kw),
        lambda **kw: SpecEngine(params, cfg, draft, dcfg, max_batch=1, max_len=16, **kw),
        lambda **kw: spec.speculative_generate(params, draft, prompt, *caches(), cfg, dcfg, 2,
                                               **kw),
        lambda **kw: spec.speculative_generate_sampled(params, draft, prompt, *caches(), cfg,
                                                       dcfg, 2, **kw),
        lambda **kw: spec.speculative_generate_batched(params, draft, prompt, *caches(), cfg,
                                                       dcfg, 2, **kw),
        lambda **kw: measure_engine_throughput(params, cfg, slots=1, burst=1, requests=1, ctx=3,
                                               gen=2, reps=1, **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        call(device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_benchmark.main(["--method", "engine", "--model", "tiny"])


@pytest.mark.parametrize("module,preset", [(opt, "opt-tiny"), (phi, "phi-tiny"),
                                           (bloom, "bloom-tiny"), (falcon, "falcon-tiny")])
def test_family_entry_points_raise_without_a_gpu_unless_cpu_is_named(monkeypatch, module,
                                                                      preset):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    family = module.__name__.rsplit(".", 1)[1]
    cfg = getattr(module, f"{family.upper()}_PRESETS")[preset]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_packed_model(cfg, g=32, r=8, family=family)
    assert module.init_params(cfg, device="cpu")["embed"].device.type == "cpu"
    params = build_packed_model(cfg, g=32, r=8, dtype=torch.float32, device="cpu",
                                family=family)
    api = get_model_api(family)
    cache = api.init_cache(cfg, 1, 8, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(params, torch.zeros(1, 4, dtype=torch.int64), cache, cfg, 2, api=api)
    tokens, _ = generate(params, torch.zeros(1, 4, dtype=torch.int64), cache, cfg, 2, api=api,
                         device="cpu")
    assert tokens.shape == (1, 2)
