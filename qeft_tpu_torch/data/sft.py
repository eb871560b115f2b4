"""Supervised fine-tuning data: Alpaca-style prompts, prompt-masked labels
and shuffled batches.  Counterpart of ``qeft_tpu/data/sft.py``; the same
seed gives the same arrays in both packages.

Only the synthetic instruction set is ported: the Platypus, Alpaca, OASST1
and wikitext sets need their rows and a tokenizer as local files, which the
repository does not hold, so those names raise and say so.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional

import numpy as np

from qeft_tpu_torch.finetune import IGNORE_INDEX

ALPACA_TEMPLATE_INPUT = (
    "Below is an instruction that describes a task, paired with an input that "
    "provides further context. Write a response that appropriately completes "
    "the request.\n\n### Instruction:\n{instruction}\n\n### Input:\n{input}"
    "\n\n### Response:\n"
)
ALPACA_TEMPLATE_NO_INPUT = (
    "Below is an instruction that describes a task. Write a response that "
    "appropriately completes the request.\n\n### Instruction:\n{instruction}"
    "\n\n### Response:\n"
)
FILE_DATASETS = {
    "platypus": "garage-bAInd/Open-Platypus",
    "alpaca": "tatsu-lab/alpaca",
    "oasst1": "timdettmers/openassistant-guanaco",
    "wikitext": "wikitext-2-raw-v1",
    "wikitext2": "wikitext-2-raw-v1",
}


def alpaca_prompt(instruction: str, inp: str = "") -> str:
    if inp:
        return ALPACA_TEMPLATE_INPUT.format(instruction=instruction, input=inp)
    return ALPACA_TEMPLATE_NO_INPUT.format(instruction=instruction)


@dataclasses.dataclass
class SFTExample:
    prompt_ids: np.ndarray
    response_ids: np.ndarray


def mask_and_pad(examples: List[SFTExample], max_len: int, pad_id: int = 0,
                 train_on_prompt: bool = False):
    """(input_ids, labels) int64 [B, max_len]; prompt positions get
    IGNORE_INDEX unless ``train_on_prompt``, padding always does."""
    b = len(examples)
    input_ids = np.full((b, max_len), pad_id, np.int64)
    labels = np.full((b, max_len), IGNORE_INDEX, np.int64)
    for i, ex in enumerate(examples):
        seq = np.concatenate([ex.prompt_ids, ex.response_ids])[:max_len]
        input_ids[i, : len(seq)] = seq
        start = 0 if train_on_prompt else min(len(ex.prompt_ids), max_len)
        labels[i, start: len(seq)] = seq[start: len(seq)]
    return input_ids, labels


def synthetic_sft_examples(n: int, vocab_size: int, seed: int = 0, prompt_len=(4, 24),
                           resp_len=(8, 48)) -> List[SFTExample]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pl = int(rng.integers(*prompt_len))
        rl = int(rng.integers(*resp_len))
        out.append(SFTExample(prompt_ids=rng.integers(0, vocab_size, pl),
                              response_ids=rng.integers(0, vocab_size, rl)))
    return out


def load_sft_examples(dataset: str, tokenizer_path: Optional[str], n: Optional[int],
                      vocab_size: int, seed: int = 0) -> List[SFTExample]:
    if dataset == "synthetic":
        return synthetic_sft_examples(n or 256, vocab_size, seed)
    if dataset in FILE_DATASETS:
        raise FileNotFoundError(
            f"SFT dataset {dataset!r} needs local files that are not in the repository: "
            f"the {FILE_DATASETS[dataset]} rows and a tokenizer directory (--tokenizer); "
            "only 'synthetic' runs without them")
    raise ValueError(f"unknown SFT dataset {dataset}")


def batches(examples: List[SFTExample], batch_size: int, max_len: int, seed: int,
            epochs: int = 1, pad_id: int = 0,
            train_on_prompt: bool = False) -> Iterator[Dict[str, np.ndarray]]:
    """Full batches of a fresh permutation per epoch (a remainder is dropped)."""
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        order = rng.permutation(len(examples))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            chunk = [examples[j] for j in order[i: i + batch_size]]
            input_ids, labels = mask_and_pad(chunk, max_len, pad_id, train_on_prompt)
            yield {"input_ids": input_ids, "labels": labels}
