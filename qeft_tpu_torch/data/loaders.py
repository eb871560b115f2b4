"""Calibration and evaluation tokens: the ``synthetic`` source and local
``.npy`` token files of ``qeft_tpu/data/loaders.py``, copied so the port
needs nothing of the JAX package (the same seed gives the same tokens in
both packages), and its random-document crops.  The Hugging Face sources
(wikitext2, ptb, c4, platypus, hellaswag) need files the repository does
not hold and raise (ROADMAP A7b)."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def _crop_samples(ids: np.ndarray, nsamples: int, seqlen: int, seed: int) -> np.ndarray:
    """Seeded random seqlen-token crops."""
    rng = np.random.default_rng(seed)
    n = ids.shape[0]
    out = np.empty((nsamples, seqlen), dtype=np.int64)
    for i in range(nsamples):
        start = int(rng.integers(0, n - seqlen - 1))
        out[i] = ids[start: start + seqlen]
    return out


def _sample_doc_crops(doc_tokens: Callable[[int], np.ndarray], n_docs: int, nsamples: int,
                      seqlen: int, seed: int) -> np.ndarray:
    """Per-sample random-document crops (the c4 calibration protocol): each
    sample draws documents until one is longer than ``seqlen`` tokens, then
    a random ``seqlen`` window of that document."""
    rng = np.random.default_rng(seed)
    out = np.empty((nsamples, seqlen), dtype=np.int64)
    for i in range(nsamples):
        while True:
            ids = doc_tokens(int(rng.integers(0, n_docs)))
            if ids.shape[0] > seqlen:
                break
        start = int(rng.integers(0, ids.shape[0] - seqlen))
        out[i] = ids[start: start + seqlen]
    return out


def _synthetic_corpus(vocab_size: int, length: int, seed: int) -> np.ndarray:
    """Zipfian unigram draws with injected repeated trigrams."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks**1.1
    probs /= probs.sum()
    ids = rng.choice(vocab_size, size=length, p=probs)
    for _ in range(length // 64):
        pos = int(rng.integers(0, length - 8))
        ids[pos + 3: pos + 6] = ids[pos: pos + 3]
    return ids.astype(np.int64)


def _not_ported(name: str):
    return NotImplementedError(
        f"dataset {name!r}: only 'synthetic' and local .npy token files are ported; the "
        "Hugging Face sources need files the repository does not hold (ROADMAP A7b)")


def get_calibration_tokens(name: str, nsamples: int, seed: int, seqlen: int,
                           model: Optional[str] = None, vocab_size: int = 32000) -> np.ndarray:
    """[nsamples, seqlen] calibration crops of ``synthetic`` or a ``.npy``
    token stream."""
    if name == "synthetic":
        corpus = _synthetic_corpus(vocab_size, max(seqlen * (nsamples + 2), 1 << 16), seed)
    elif name.endswith(".npy"):
        corpus = np.load(name)
    else:
        raise _not_ported(name)
    return _crop_samples(corpus, nsamples, seqlen, seed)


def get_loaders(name: str, nsamples: int = 128, seed: int = 0, seqlen: int = 2048,
                model: Optional[str] = None, train: bool = True,
                vocab_size: int = 32000) -> np.ndarray:
    """train=True -> [nsamples, seqlen] crops; train=False -> the test
    stream (``synthetic``: its own seed; ``.npy``: the whole file)."""
    if train:
        return get_calibration_tokens(name, nsamples, seed, seqlen, model, vocab_size)
    if name == "synthetic":
        return _synthetic_corpus(vocab_size, 1 << 18, seed + 1)
    if name.endswith(".npy"):
        return np.load(name)
    raise _not_ported(name)
