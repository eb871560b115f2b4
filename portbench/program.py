"""The system under test, ``qeft_tpu_torch``, as the benchmark reaches it:
its model configuration, its model API and its tree of packed linears, built
around the benchmark's own tensors (no copy), each the family's
(`portbench.families`).  Only the drivers import this module."""

from __future__ import annotations

from typing import Dict

from portbench.families import family
from portbench.shapes import Dims


def port_family(dims: Dims) -> str:
    """The name the port's ``get_model_api`` and ``make_train_step`` know the
    family by."""
    return family(dims.family).port_family


def config(dims: Dims):
    """The port's configuration object of the family."""
    return family(dims.family).config(dims)


def api(dims: Dims):
    from qeft_tpu_torch.models.api import get_model_api

    return get_model_api(port_family(dims))


def tree(dims: Dims, raw: Dict) -> Dict:
    """The port's parameter tree over ``raw`` (`weights.make`)."""
    return family(dims.family).tree(dims, raw)
