"""Perplexity over consecutive ``seqlen`` windows of a token stream.
Counterpart of ``qeft_tpu/eval.py``: `eval_ppl`, and `eval_ppl_streamed`
for a tree held in host memory."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from qeft_tpu_torch.checkpoint import tree_map
from qeft_tpu_torch.device import check_on, resolve_device
from qeft_tpu_torch.models.api import ModelApi, get_model_api
from qeft_tpu_torch.ops.packing import QLinearParams


def _window_nll(params: Dict, tokens: torch.Tensor, cfg, api: ModelApi) -> torch.Tensor:
    """Sum of next-token negative log-likelihoods over one [1, S] window."""
    logits = api.forward(params, tokens, cfg).to(torch.float32)
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    return -logp.gather(-1, tokens[:, 1:, None]).sum()


@torch.inference_mode()
def eval_ppl(params: Dict, test_tokens: np.ndarray, cfg, seqlen: int = 2048,
             max_windows: int = 0, api: Optional[ModelApi] = None,
             family: str = "llama", device=None) -> float:
    """exp(total NLL / total predicted tokens) over the first windows."""
    device = resolve_device(device)
    check_on(params["embed"], device, "the model")
    api = api or get_model_api(family)
    n_windows = len(test_tokens) // seqlen
    if max_windows:
        n_windows = min(n_windows, max_windows)
    if n_windows == 0:
        raise ValueError(
            f"test set ({len(test_tokens)} tokens) shorter than one eval "
            f"window (seqlen={seqlen}); pass a smaller --seqlen"
        )
    total = 0.0
    for i in range(n_windows):
        window = torch.as_tensor(np.asarray(test_tokens[i * seqlen: (i + 1) * seqlen]),
                                 dtype=torch.int64, device=device)[None, :]
        total += float(_window_nll(params, window, cfg, api))
    return float(np.exp(total / (n_windows * (seqlen - 1))))


def _one_layer(layers: Dict, i: int, meta, device: torch.device) -> Dict:
    """Layer ``i`` of a stacked llama layers tree as a one-layer tree on
    ``device`` (dense tensors or packed linears), member linears (a fake
    tree's q/k/v, up/gate) fused into the stages the block reads."""
    from qeft_tpu_torch.pipeline import fuse_packed_stages, fuse_tensors

    one = tree_map(lambda a: a[i: i + 1].to(device), layers)
    if any(isinstance(v, QLinearParams) for v in one.values()):
        return fuse_packed_stages({"layers": one}, meta)["layers"]
    return fuse_tensors(one, meta)


@torch.inference_mode()
def eval_ppl_streamed(params: Dict, test_tokens: np.ndarray, cfg, meta, seqlen: int = 2048,
                      max_windows: int = 0, device=None) -> float:
    """`eval_ppl` of a llama-family tree held in host memory, for models
    larger than the card (``qeft_tpu/eval.py::eval_ppl_streamed``; the
    reference's harness streams blocks between CPU and GPU the same way):
    every window is embedded, then each block moves to ``device`` and runs
    over all windows before the next one comes, then the final norm and the
    head give each window's NLL.  Dense linears are ``torch.matmul`` and
    attention is K3 on the card, as `eval_ppl` runs a dense tree there (a
    packed tree's linears run their kernels).  ``device`` defaults to the
    GPU, which must exist; ``"cpu"`` runs the branch with host and device
    the same."""
    from qeft_tpu_torch.models.llama import _lm_head

    device = resolve_device(device)
    if meta.family not in ("llama", "gemma"):
        raise ValueError(f"eval_ppl_streamed covers the llama family, as the JAX package's "
                         f"does, not {meta.family!r}: evaluate it with eval_ppl")
    api = get_model_api(meta.family)
    n_windows = len(test_tokens) // seqlen
    if max_windows:
        n_windows = min(n_windows, max_windows)
    if n_windows == 0:
        raise ValueError(
            f"test set ({len(test_tokens)} tokens) shorter than one eval "
            f"window (seqlen={seqlen}); pass a smaller --seqlen"
        )
    tokens = torch.as_tensor(np.stack([np.asarray(test_tokens[i * seqlen: (i + 1) * seqlen])
                                       for i in range(n_windows)]),
                             dtype=torch.int64, device=device)
    x = api.embed({"embed": params["embed"].to(device)}, tokens, cfg)
    layers = params["layers"]
    for i in range(layers["input_ln"].shape[0]):  # K3 on the card, as calibration runs a block
        block = api.calibration_block(_one_layer(layers, i, meta, device), cfg, seqlen, device)
        for w in range(n_windows):
            x[w: w + 1] = block(x[w: w + 1], None)
        del block
    head = tree_map(lambda t: t.to(device), {"final_ln": params["final_ln"],
                                             "lm_head": params["lm_head"]})
    total = 0.0
    for w in range(n_windows):  # one window's [S, V] f32 logits at a time
        logits = _lm_head(head, x[w: w + 1], cfg).to(torch.float32)
        logp = torch.log_softmax(logits[:, :-1], dim=-1)
        total += float(-logp.gather(-1, tokens[w: w + 1, 1:, None]).sum())
    return float(np.exp(total / (n_windows * (seqlen - 1))))
