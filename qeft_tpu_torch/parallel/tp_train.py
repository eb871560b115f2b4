"""Tensor-parallel WCT training (``qeft_tpu/parallel/tp_train.py``) is not
ported yet: ROADMAP A10b.  Each entry point raises and names the item."""

from __future__ import annotations


def _not_ported(name: str):
    raise NotImplementedError(f"parallel.tp_train.{name} (tensor-parallel WCT training) is not "
                              "ported: ROADMAP A10b")


def tp_train_specs(*args, **kwargs):
    _not_ported("tp_train_specs")


def tp_shard_wct(*args, **kwargs):
    _not_ported("tp_shard_wct")


def make_tp_loss_and_grad(*args, **kwargs):
    _not_ported("make_tp_loss_and_grad")


def make_tp_train_step(*args, **kwargs):
    _not_ported("make_tp_train_step")
