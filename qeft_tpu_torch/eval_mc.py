"""Multiple-choice evaluation by choice log-likelihood.  Counterpart of
``qeft_tpu/eval_mc.py``: each question is scored by the summed next-token
log-likelihood of each choice after the context, through the serving forward
(K2 and K3 on the GPU).  The MMLU rows and tokenizer are files the repository
does not hold, so `load_mmlu_examples` raises and says so; the synthetic
suite runs anywhere."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from qeft_tpu_torch.device import check_on, resolve_device
from qeft_tpu_torch.models.api import get_model_api


@dataclasses.dataclass
class MCExample:
    context_ids: np.ndarray  # prompt tokens
    choice_ids: List[np.ndarray]  # one token array per choice
    label: int


def _seq_logprobs(params, tokens: torch.Tensor, cfg, family: str) -> torch.Tensor:
    """Per-position next-token log-probs [1, S-1] of one [1, S] sequence."""
    logits = get_model_api(family).forward(params, tokens, cfg).to(torch.float32)
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    return logp.gather(-1, tokens[:, 1:, None])[..., 0]


@torch.inference_mode()
def score_example(params, ex: MCExample, cfg, family: str = "llama", device=None) -> int:
    """Argmax over the summed choice-continuation log-likelihoods."""
    device = resolve_device(device)
    scores = []
    for choice in ex.choice_ids:
        seq = torch.as_tensor(np.concatenate([ex.context_ids, choice])[None, :],
                              dtype=torch.int64, device=device)
        lp = _seq_logprobs(params, seq, cfg, family)
        scores.append(float(lp[0, -len(choice):].sum()))
    return int(np.argmax(scores))


def evaluate_mc(params, examples: List[MCExample], cfg, family: str = "llama",
                device=None) -> Dict:
    device = resolve_device(device)
    check_on(params["embed"], device, "the model")
    correct = sum(int(score_example(params, ex, cfg, family, device) == ex.label)
                  for ex in examples)
    return {"accuracy": correct / max(len(examples), 1), "n": len(examples)}


def synthetic_mc_examples(n: int, vocab_size: int, seed: int = 0) -> List[MCExample]:
    """The correct choice repeats a context trigram, which any
    induction-capable model scores above random continuations."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ctx = rng.integers(0, vocab_size, 12)
        correct = ctx[3:6].copy()
        choices = [rng.integers(0, vocab_size, 3) for _ in range(3)]
        label = int(rng.integers(0, 4))
        choices.insert(label, correct)
        out.append(MCExample(ctx, choices, label))
    return out


def load_mmlu_examples(tokenizer_path: str, split: str = "validation",
                       n: Optional[int] = None) -> List[MCExample]:
    raise FileNotFoundError(
        "MMLU needs local files that are not in the repository: the cais/mmlu "
        f"'all' {split} rows and the tokenizer directory {tokenizer_path!r}; use "
        "--mmlu_source synthetic")
