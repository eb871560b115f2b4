"""The model layer's glue (``models/common.py`` and each family's module:
the PyTorch ops between the port's kernels): share of the decode steps'
device busy time in activities that are not the port's own kernels (every
``__global__`` kernel of ``qeft_tpu_torch/csrc``), copies and fills
included."""

import re

from portbench import portkernels


def read(run):
    tr = run.trace
    if tr is None:
        return None
    own = portkernels.pattern()
    acts = [a for a in tr.activities if a.index is not None and a.span != "prefill"]
    total = sum(a.end - a.start for a in acts)
    if not total or own is None:
        return None
    other = sum(a.end - a.start for a in acts if not re.search(own, a.name))
    return 100.0 * other / total
