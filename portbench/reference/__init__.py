"""The plain reference: each family's published equations in float32 plain
PyTorch (TF32 off), reading the benchmark's packed inputs and unpacking them
itself.  It imports nothing of the port and takes nothing the port made.

``family(name)`` gives the family's module (``reference/<family>.py``),
found by the configuration's ``family``; each has ``embed``, ``block`` and
``logits`` over `common`'s pieces, and may have ``layer_params(raw, dims,
l, slabs=None)``, one layer's f32 parameters, in place of
`common.layer_params` (`layer_params`)."""

from __future__ import annotations

import importlib

from portbench.reference import common


def family(name: str):
    return importlib.import_module(f"portbench.reference.{name}")


def layer_params(fam):
    """The reference family ``fam``'s ``layer_params``, else `common`'s."""
    return getattr(fam, "layer_params", common.layer_params)
