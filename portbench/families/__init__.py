"""Each model family the benchmark runs, a module of its own found by the
configuration's ``family`` (``families/<family>.py``), beside its plain
reference (``reference/<family>.py``).  The generic modules reach a family
only through `family`; none of them tests a family's name.

A family module gives these hooks (``dense.py`` holds what the dense
families share):

- ``port_family``: the name the port's ``get_model_api`` and
  ``make_train_step`` know the family by;
- ``dims(cfg) -> Dims``: the family's sizes and its packed linears, a
  `portbench.shapes.Dims` or a subclass with fields of the family's own;
- ``config(dims)``, ``tree(dims, raw)``: the port's configuration object and
  its parameter tree over the benchmark's tensors;
- ``leaves(dims, seed, device)``: the model as plain tensors, its packed
  linears through `portbench.weights.packed` (``lead`` gives them leading
  axes, such as an expert axis), the rest the family's own;
- ``decode_step(dims, *step)``, ``train_step_ops(dims, batch, seq)``:
  operations and bytes of one step;
- ``expect_decode(run)``, ``expect_train(run)``: the kernel calls a traced
  stretch must hold, each ``(M, K, N, g, r, bias)``, and the decode steps
  (tuples ``decode_step`` takes whole)."""

from __future__ import annotations

import importlib


def family(name: str):
    """``portbench.families.<name>``; a missing one is named in the error."""
    module = f"portbench.families.{name}"
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise ModuleNotFoundError(f"no family {name!r}: portbench/families/{name}.py is missing",
                                  name=module) from e
