"""The plain reference: each family's published equations in float32 plain
PyTorch (TF32 off), reading the benchmark's packed inputs and unpacking them
itself.  It imports nothing of the port and takes nothing the port made.

``family(name)`` gives the family's module (``opt.py``, ``falcon.py``),
found by the configuration's ``family``; each has ``embed``, ``block`` and
``logits`` over `common`'s pieces."""

from __future__ import annotations

import importlib


def family(name: str):
    return importlib.import_module(f"portbench.reference.{name}")
