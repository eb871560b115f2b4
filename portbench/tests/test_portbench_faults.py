"""A whole run with the chip's look skipped and the timed path broken
underneath comes out not correct, under the cells' own limits, once for
each fault the cell can have; the same run unbroken comes out correct."""

import pytest
import torch

from portbench import run
from portbench.tests import small

DECODE = ["opt-6.7b.chat-b1", "falcon-7b.batch8"]
TRAIN = "opt-6.7b.wct-train"


def one_run(cell, seed=2**31 + 17):
    return run.execute(small.BENCH, cell, seed, 0.3, False, torch.device("cpu"),
                       files=small.files(cell))


@pytest.mark.parametrize("cell", DECODE + [TRAIN])
def test_unbroken_runs_are_correct(cell):
    assert one_run(cell)["correct"] is True


@pytest.mark.parametrize("cell", DECODE)
def test_a_token_altered_where_it_is_produced(monkeypatch, cell):
    from qeft_tpu_torch import generate as gen

    real, calls = gen._sample_token, []

    def altered(logits, generator, sc):
        tok = real(logits, generator, sc)
        calls.append(1)
        return (tok + 1) % logits.shape[-1] if len(calls) % 3 == 0 else tok

    monkeypatch.setattr(gen, "_sample_token", altered)
    res = one_run(cell)
    assert res["correct"] is False and res["check"]["gap"]["value"] > res["check"]["gap"]["limit"]


def test_half_of_the_batch_left_out_of_decode(monkeypatch):
    from qeft_tpu_torch import generate as gen

    real = gen.generate

    def half(params, prompt, cache, cfg, n, *a, **kw):
        tokens, cache = real(params, prompt, cache, cfg, n, *a, **kw)
        b = tokens.shape[0] // 2
        return torch.cat([tokens[:b], tokens[:b]]), cache

    monkeypatch.setattr(gen, "generate", half)
    assert one_run("falcon-7b.batch8")["correct"] is False


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    from qeft_tpu_torch import finetune

    real = finetune.make_optimizer

    def frozen_steps(*a, **kw):
        opt = real(*a, **kw)
        inner = opt.optimizer.step

        def step(*sa, **skw):
            before = [p.detach().clone() for p in opt.params]
            out = inner(*sa, **skw)
            with torch.no_grad():
                for p, b in zip(opt.params, before):
                    p.copy_(b)
            return out

        opt.optimizer.step = step
        return opt

    monkeypatch.setattr(finetune, "make_optimizer", frozen_steps)
    res = one_run(TRAIN)
    assert res["correct"] is False and res["check"]["change"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_of_training(monkeypatch):
    from qeft_tpu_torch import finetune

    real = finetune.causal_lm_loss

    def half_mean(logits, labels):
        b = logits.shape[0] // 2
        return real(logits[:b], labels[:b])

    monkeypatch.setattr(finetune, "causal_lm_loss", half_mean)
    assert one_run(TRAIN)["correct"] is False
