"""Spans and traces of the port (``qeft_tpu_torch/utils/profiling.py``): a
span opens a profiler range only while a profiler records and no CUDA
graph is being captured; a tiny OPT ``generate`` and WCT step record their
spans nested as the program nests them; and a Chrome trace written by
``profile_trace`` on the CPU (on the card it also records CUDA activity;
``chip_smoke.py`` checks it names K1)."""

import dataclasses
import json

import pytest
import torch

from qeft_tpu_torch.finetune import TrainConfig, make_optimizer, make_train_step, split_wct
from qeft_tpu_torch.generate import generate
from qeft_tpu_torch.models import opt
from qeft_tpu_torch.models.api import get_model_api
from qeft_tpu_torch.testing import build_packed_model
from qeft_tpu_torch.utils import profile_trace, span
from qeft_tpu_torch.utils import profiling


def _names(prof):
    return [e.name for e in prof.events()]


def _ancestors(event):
    out, p = [], event.cpu_parent
    while p is not None:
        out.append(p.name)
        p = p.cpu_parent
    return out


def _tiny_opt():
    cfg = dataclasses.replace(opt.OPT_PRESETS["opt-tiny"], dtype=torch.float32)
    return cfg, build_packed_model(cfg, g=32, r=8, dtype=torch.float32, device="cpu",
                                   family="opt")


def test_span_opens_no_range_without_a_profiler(monkeypatch):
    def no_range(name):
        raise AssertionError(f"a range was opened for {name}")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    assert not torch._C._autograd._profiler_enabled()
    with span("qeft.test.off") as s:
        assert s is None
    assert span("qeft.test.off") is span("qeft.test.other")  # one shared no-op context


def test_span_opens_no_range_while_a_graph_is_captured(monkeypatch):
    capturing = [True]
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("qeft.test.captured"):
            torch.ones(4) + 1
        capturing[0] = False
        with span("qeft.test.eager"):
            torch.ones(4) + 1
    names = _names(prof)
    assert "qeft.test.captured" not in names
    assert names.count("qeft.test.eager") == 1
    assert span("qeft.test.after") is profiling._NO_RANGE  # the profiler has stopped


def test_generate_records_its_spans_nested(tmp_path):
    cfg, params = _tiny_opt()
    api = get_model_api("opt")
    cache = api.init_cache(cfg, 1, 16, dtype=torch.float32)
    prompt = torch.arange(1, 7, dtype=torch.int64)[None, :]
    with profile_trace(str(tmp_path), device="cpu") as prof:
        generate(params, prompt, cache, cfg, 4, api=api, device="cpu")
    events = prof.events()
    names = [e.name for e in events]
    assert names.count("qeft.generate.prefill") == 1
    assert names.count("qeft.model.embed") == names.count("qeft.model.head") == 4  # 1 + 3 steps
    assert names.count("qeft.model.block") == 4 * cfg.num_layers
    assert names.count("qeft.model.attention") == 4 * cfg.num_layers
    in_prefill = [e for e in events if "qeft.generate.prefill" in _ancestors(e)]
    for what in ("qeft.model.attention", "qeft.linear.forward"):
        nested = [_ancestors(e) for e in in_prefill if e.name == what]
        assert nested, what
        for chain in nested:  # the innermost model span first, the prefill outside it
            assert chain.index("qeft.model.block") < chain.index("qeft.generate.prefill")
    # six linears a block, and the head (tied to the embedding: no packed linear)
    assert sum(e.name == "qeft.linear.forward" for e in in_prefill) == 6 * cfg.num_layers


def test_wct_step_records_its_spans_nested(tmp_path):
    cfg, params = _tiny_opt()
    oweights, frozen = split_wct(params)
    step = make_train_step(cfg, make_optimizer(TrainConfig(total_steps=10), oweights),
                           remat=True, family="opt")
    ids = torch.arange(8, dtype=torch.int64).reshape(2, 4) % cfg.vocab_size
    with profile_trace(str(tmp_path), device="cpu") as prof:
        step(oweights, frozen, ids, ids.clone())
    events = prof.events()
    names = [e.name for e in events]
    for name in ("qeft.finetune.loss", "qeft.finetune.backward", "qeft.finetune.optimizer"):
        assert names.count(name) == 1, name
    # each block once forward and once recomputed in the backward (remat)
    assert names.count("qeft.model.block") == 2 * cfg.num_layers
    in_loss = [e for e in events if "qeft.finetune.loss" in _ancestors(e)]
    for what in ("qeft.model.attention", "qeft.linear.forward"):
        chains = [_ancestors(e) for e in in_loss if e.name == what]
        assert len(chains) == (1 if what.endswith("attention") else 6) * cfg.num_layers
        for chain in chains:
            assert chain.index("qeft.model.block") < chain.index("qeft.finetune.loss")
    backward = [_ancestors(e) for e in events if e.name == "qeft.linear.backward"]
    assert len(backward) == 6 * cfg.num_layers
    assert all("qeft.finetune.backward" in chain for chain in backward)  # the CPU's one thread
    recomputed = [e for e in events if e.name == "qeft.model.block"
                  and "qeft.finetune.backward" in _ancestors(e)]
    assert len(recomputed) == cfg.num_layers


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path), device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.key for e in prof.key_averages()}
    assert any("mm" in n for n in names)
    trace = json.load(open(tmp_path / "trace.json"))
    assert trace["traceEvents"]
    with profile_trace(str(tmp_path / "off"), enabled=False) as prof:
        pass
    assert prof is None and not (tmp_path / "off").exists()


def test_profile_trace_needs_a_gpu_unless_cpu_is_named(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with profile_trace(str(tmp_path)):
            pass
