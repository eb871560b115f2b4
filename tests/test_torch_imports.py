"""The port stands alone: it imports neither JAX nor the JAX package (nor
``safetensors`` or ``transformers``, which the machine with the card lacks),
its entry points refuse to run on the CPU unless the caller names it, and
the JAX package's kernel-path environment variables are never ignored
without a word."""

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
BANNED = ("jax", "jaxlib", "ml_dtypes", "qeft_tpu", "safetensors", "transformers")


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
    "0", "" and "false") asks ``main --load`` for an RTN int4 lm_head; the
    port now honours it (``raises``: the value asks for the packed head).
    The logits of a JAX-written checkpoint served as ``main --load`` serves
    it match JAX's model with ``main``'s head (``rtn_pack_linear`` of the
    f32 head) within 1e-4 of their scale, and main's eval runs on it."""
    import jax.numpy as jnp
    import numpy as np

    from qeft_tpu.checkpoint import save_packed as jax_save_packed
    from qeft_tpu.models import llama as jl
    from qeft_tpu.pipeline import rtn_pack_linear as jax_rtn_pack_linear
    from qeft_tpu_torch.models import llama as tl
    from qeft_tpu_torch.ops.packing import QLinearParams
    from tests.torch_parity import assert_close_to_scale, random_packed, torch_cfg

    monkeypatch.setenv("QEFT_QUANT_LMHEAD", value)
    jparams = random_packed("tiny")
    cfg = jl.LLAMA_PRESETS["tiny"]
    path = str(tmp_path / "tiny_packed")
    jax_save_packed(path, jparams, cfg)
    params, _, _ = torch_main.load_for_serving(path, torch.device("cpu"))
    assert isinstance(params["lm_head"], QLinearParams) == raises
    if raises:  # qeft_tpu/main.py:91-100
        jparams = {**jparams, "lm_head": jax_rtn_pack_linear(
            jparams["lm_head"].astype(jnp.float32))}
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 12))
    want = jl.llama_forward(jparams, jnp.asarray(tokens), cfg)
    with torch.no_grad():
        got = tl.llama_forward(params, torch.as_tensor(tokens), torch_cfg("tiny"))
    assert_close_to_scale(got, want)
    res = torch_main.main(["--load", path, "--device", "cpu", "--eval", "--eval_windows", "1",
                           "--seqlen", "16"])
    assert np.isfinite(res["ppl_synthetic"])


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


def test_quantize_entry_points_raise_without_a_gpu_unless_cpu_is_named(monkeypatch, tmp_path):
    """extract_outidx, main's quantize path, convert, load_fake and
    load_hf_model."""
    from qeft_tpu_torch import convert, extract_outidx
    from qeft_tpu_torch.checkpoint import load_fake, save_fake
    from qeft_tpu_torch.models.hf_loader import load_hf_model
    from qeft_tpu_torch.testing import write_hf_opt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    common = ["--model", "tiny", "--target_rank", "8", "--groupsize", "64", "--nsamples", "1",
              "--seqlen", "16", "--no_frob_norm"]
    out = str(tmp_path / "oidx")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        extract_outidx.main(common + ["--output_dir", out])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_main.main(common)
    assert not os.path.exists(out)
    cfg = LLAMA_PRESETS["tiny"]
    fake = str(tmp_path / "fake")
    save_fake(fake, init_params(cfg, device="cpu"), {}, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_fake(fake)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.main([fake, str(tmp_path / "packed")])
    assert load_fake(fake, device="cpu")[0]["embed"].device.type == "cpu"
    hf = str(tmp_path / "hf")
    ocfg = opt.OPT_PRESETS["opt-tiny"]
    write_hf_opt(hf, opt.init_params(ocfg, device="cpu"), ocfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_hf_model(hf)
    assert load_hf_model(hf, device="cpu")[0]["embed"].device.type == "cpu"


@pytest.mark.parametrize("name", ["QEFT_PALLAS", "QEFT_FLASH_ATTN", "QEFT_PALLAS_ATTN",
                                  "QEFT_GEMV_F32W"])
def test_ablation_env_vars_raise_naming_their_item(monkeypatch, tmp_path, name):
    """An "off" value asks for the JAX package's ablation of a kernel, which
    the port now honours (tests/test_torch_ablations.py): every entry point
    reads it into its flag, and its one announcement names the kernels it
    stands in for; "1" asks for the kernels again.  (The name is kept from
    when these raised.)"""
    from qeft_tpu_torch import env
    from qeft_tpu_torch.device import resolve_device

    flag, _, what = env.ABLATIONS[name]
    monkeypatch.setattr(env, "_announced", set())
    monkeypatch.setenv(name, "0")
    assert resolve_device("cpu").type == "cpu" and getattr(env, flag) is False
    env.announce(name)
    assert any(f"K{i}" in what for i in range(1, 9)) and name in env._announced
    monkeypatch.setenv(name, "1")
    assert resolve_device("cpu").type == "cpu" and getattr(env, flag) is True


@pytest.mark.parametrize("name,want", [("QEFT_FUSED_DECODE", "qgemv_stacked"),
                                       ("QEFT_STACKED_GEMV", "qgemv")])
def test_kernel_selectors_pick_the_other_kernel(monkeypatch, name, want):
    """``QEFT_FUSED_DECODE=0`` runs each decode stage as the norm, K6 and
    the residual add; ``QEFT_STACKED_GEMV=0`` runs K5 on each layer's view
    (as qeft_tpu's scan-sliced layers); the decode step's logits stay those
    of the fused path within 1e-5 of their scale."""
    from qeft_tpu_torch import env
    from qeft_tpu_torch.device import resolve_device
    from qeft_tpu_torch.ops import qlinear

    for flag in ("STACKED_GEMV", "FUSED_DECODE"):
        monkeypatch.setattr(env, flag, getattr(env, flag))
    cfg = LLAMA_PRESETS["tiny"]
    params = build_packed_model(cfg, g=64, r=8, dtype=torch.float32, device="cpu")
    api = get_model_api("llama")
    calls = []
    for kernel in ("qgemv_stacked_fused", "qgemv_stacked", "qgemv"):
        real = getattr(qlinear, kernel)
        monkeypatch.setattr(qlinear, kernel, lambda *a, _k=kernel, _f=real, **kw:
                            calls.append(_k) or _f(*a, **kw))

    def step():
        cache = init_kv_cache(cfg, 1, 8, dtype=torch.float32)
        calls.clear()
        with torch.no_grad():
            logits, _ = api.decode_step(params, torch.tensor([[3]]), cache, 2, cfg)
        return logits, set(calls)

    fused, kernels = step()
    assert kernels == {"qgemv_stacked_fused"}
    monkeypatch.setenv(name, "0")
    resolve_device("cpu")
    got, kernels = step()
    assert kernels == {want}
    scale = fused.abs().max().item()
    torch.testing.assert_close(got, fused, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("name", ["QEFT_ATTN_BLK", "QEFT_FLASH_BLKQ", "QEFT_FLASH_BLKK",
                                  "QEFT_O_BAND", "QEFT_PAD_UPGATE", "QEFT_SEXP_REPEAT",
                                  "QEFT_GEMV_TELE", "QEFT_GEMV_BN"])
def test_tpu_tiling_knobs_warn_once_per_process(monkeypatch, name):
    import warnings

    from qeft_tpu_torch import env
    from qeft_tpu_torch.device import resolve_device

    monkeypatch.setattr(env, "_warned", set())
    monkeypatch.setenv(name, "512")
    with pytest.warns(RuntimeWarning, match=name):
        resolve_device("cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        resolve_device("cpu")


def test_this_slices_modules_are_scanned_for_banned_imports():
    """import_reference, eval (eval_ppl_streamed), generate
    (generate_simple) and the streaming pipeline are among the modules the
    two tests above hold to the ban on jax, qeft_tpu, safetensors and
    transformers."""
    mods = {m for _, m in _modules()}
    assert {"qeft_tpu_torch.import_reference", "qeft_tpu_torch.eval",
            "qeft_tpu_torch.generate", "qeft_tpu_torch.pipeline",
            "qeft_tpu_torch.extract_outidx"} <= mods


def test_streaming_and_import_entry_points_raise_without_a_gpu_unless_cpu_is_named(
        monkeypatch, tmp_path):
    """import_reference_packed / _wct and the import_reference CLI,
    eval_ppl_streamed and generate_simple."""
    from qeft_tpu_torch import import_reference as imp
    from qeft_tpu_torch.eval import eval_ppl_streamed
    from qeft_tpu_torch.generate import generate_simple
    from qeft_tpu_torch.models.registry import get_model_meta
    from qeft_tpu_torch.testing import write_reference_packed, write_reference_wct

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LLAMA_PRESETS["tiny"]
    params = build_packed_model(cfg, g=64, r=8, dtype=torch.float32, device="cpu")
    ckpt = write_reference_packed(params, cfg)
    src = str(tmp_path / "ref.pth")
    torch.save(ckpt, src)
    wct = write_reference_wct({}, src)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        imp.import_reference_packed(src, cfg, ckpt=ckpt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        imp.import_reference_wct(src, cfg, ckpt=wct)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        imp.main([src, str(tmp_path / "out"), "--model", "tiny"])
    assert not os.path.exists(str(tmp_path / "out.npz"))
    assert imp.import_reference_packed(src, cfg, ckpt=ckpt, device="cpu")[0]["embed"].device \
        .type == "cpu"
    assert imp.import_reference_wct(src, cfg, ckpt=wct, device="cpu")[1] == "llama"
    dense = init_params(cfg, device="cpu")
    stream = torch.zeros(64, dtype=torch.int64).numpy()
    meta = get_model_meta("llama")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_ppl_streamed(dense, stream, cfg, meta, seqlen=16, max_windows=1)
    assert eval_ppl_streamed(dense, stream, cfg, meta, seqlen=16, max_windows=1,
                             device="cpu") > 0
    prompt = torch.zeros(1, 4, dtype=torch.int64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate_simple(params, prompt, cfg, 2)
    assert generate_simple(params, prompt, cfg, 2, device="cpu").shape == (1, 2)


def test_main_accepts_eval_datasets_and_logfile(tmp_path):
    """``--eval_datasets`` (a comma list; a set the port cannot read raises
    naming A7b) and ``--logfile`` (one JSON line appended per run)."""
    import json

    import numpy as np

    cfg = LLAMA_PRESETS["tiny"]
    path = str(tmp_path / "tiny_packed")
    save_packed(path, build_packed_model(cfg, g=64, r=8, dtype=torch.float32, device="cpu"),
                cfg)
    npy = str(tmp_path / "tokens.npy")
    np.save(npy, np.random.default_rng(0).integers(0, cfg.vocab_size, 256))
    log = str(tmp_path / "runs.jsonl")
    argv = ["--load", path, "--device", "cpu", "--eval", "--seqlen", "32", "--eval_windows",
            "2", "--eval_datasets", f"synthetic,{npy}", "--logfile", log]
    res = torch_main.main(argv)
    torch_main.main(argv)
    lines = [json.loads(line) for line in open(log)]
    assert len(lines) == 2 and lines[0] == lines[1]
    assert lines[0]["eval_datasets"] == f"synthetic,{npy}" and lines[0]["load"] == path
    assert lines[0]["ppl_synthetic"] == res["ppl_synthetic"] and f"ppl_{npy}" in lines[0]
    with pytest.raises(NotImplementedError, match="A7b"):
        torch_main.main(argv[:-4] + ["--eval_datasets", "wikitext2"])


def test_the_parallel_package_is_scanned_for_banned_imports():
    """Every module of ``qeft_tpu_torch/parallel`` is among those the two
    tests above hold to the ban on jax and qeft_tpu."""
    mods = {m for _, m in _modules()}
    assert {f"qeft_tpu_torch.parallel.{m}" for m in
            ("mesh", "multihost", "tp_forward", "pp", "tp_pp", "sp", "tp_train")} <= mods


def test_parallel_entry_points_raise_without_a_gpu_unless_cpu_is_named(monkeypatch):
    """make_mesh, global_mesh, init_distributed, launch_ranks, the tp / pp /
    tp x pp / sp functions on a mesh made for the card, Engine(mesh=...),
    MultiHostEngine and run_benchmark --tp refuse to run on the CPU unless
    it is named; so does tensor-parallel training on a mesh made for the
    card (its functions raised naming A10b before they were ported)."""
    from qeft_tpu_torch.parallel import tp_train
    from qeft_tpu_torch.parallel.mesh import Mesh, make_mesh
    from qeft_tpu_torch.parallel.multihost import global_mesh, init_distributed, launch_ranks
    from qeft_tpu_torch.parallel.pp import pp_generate
    from qeft_tpu_torch.parallel.sp import llama_decode_step_sp, llama_prefill_sp
    from qeft_tpu_torch.parallel.tp_forward import tp_decode_step, tp_generate
    from qeft_tpu_torch.parallel.tp_pp import tppp_generate
    from qeft_tpu_torch.serving import MultiHostEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for v in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "MASTER_ADDR",
              "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v, raising=False)
    for call in (make_mesh, global_mesh, lambda: launch_ranks(print, 2),
                 lambda: MultiHostEngine(None, None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_distributed()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_benchmark.main(["--method", "engine", "--tp", "2", "--model", "tiny"])
    cfg = LLAMA_PRESETS["tiny"]
    params = build_packed_model(cfg, g=64, r=8, dtype=torch.float32, device="cpu")
    prompt = torch.zeros(1, 4, dtype=torch.int64)
    card = Mesh({"dp": 1, "tp": 1, "pp": 1, "sp": 1}, device=torch.device("cuda"))
    cache = init_kv_cache(cfg, 1, 8, device="cpu")
    for call in (lambda: tp_generate(params, prompt, cache, cfg, card, 2),
                 lambda: tp_decode_step(params, prompt[:, :1], cache, 4, cfg, card),
                 lambda: pp_generate(params, prompt, cache, cfg, card, 2),
                 lambda: tppp_generate(params, prompt, cache, cfg, card, 2),
                 lambda: llama_prefill_sp(params, prompt, cfg, card),
                 lambda: llama_decode_step_sp(params, prompt[:, :1], cache, 4, cfg, card),
                 lambda: Engine(params, cfg, mesh=card)):
        with pytest.raises(ValueError, match="expected cuda"):
            call()
    tp_card = Mesh({"dp": 1, "tp": 1}, device=torch.device("cuda"))
    ow, frozen = tp_train.tp_shard_wct(params, tp_card, cfg)
    assert set(tp_train.tp_train_specs(ow, frozen)[0]) == set(ow)
    with pytest.raises(ValueError, match="expected cuda"):
        tp_train.make_tp_loss_and_grad(cfg, tp_card, ow, frozen)
    from qeft_tpu_torch.finetune import TrainConfig, make_optimizer

    with pytest.raises(ValueError, match="expected cuda"):
        tp_train.make_tp_train_step(cfg, make_optimizer(TrainConfig(), ow), tp_card, ow, frozen)


def test_the_last_modules_are_scanned_for_banned_imports():
    """Tensor-parallel training, the dry run, the host library's bindings
    and the profiling utilities are among the modules the two tests above
    hold to the ban on jax and qeft_tpu."""
    mods = {m for _, m in _modules()}
    assert {"qeft_tpu_torch.parallel.tp_train", "qeft_tpu_torch.multihost_dryrun",
            "qeft_tpu_torch.ops.native", "qeft_tpu_torch.utils.profiling",
            "qeft_tpu_torch.utils"} <= mods


def test_the_dry_run_needs_a_gpu_unless_cpu_is_named(monkeypatch):
    from qeft_tpu_torch import multihost_dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multihost_dryrun.run()


@pytest.mark.parametrize("module", ["finetune.py", "pipeline.py"])
def test_training_and_quantization_reach_a_family_only_through_its_model_api(module):
    """``finetune`` and ``pipeline`` import nothing from ``models.llama`` and
    no underscore name of a model module, read no family's ``DECODER`` and
    import no family module by name: what a family is lives behind
    ``models.api.get_model_api``."""
    tree = ast.parse((PKG / module).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith(
                "qeft_tpu_torch.models"):
            assert node.module != "qeft_tpu_torch.models.llama"
            assert not [a.name for a in node.names if a.name.startswith("_")], node.module
        assert not (isinstance(node, ast.Attribute) and node.attr in ("DECODER", "import_module"))
        assert not (isinstance(node, ast.Name) and node.id in ("importlib", "_is_llama"))
