"""Parallel layouts over ``torch.distributed``: the mesh and its tables
(`mesh`), joining and launching ranks (`multihost`), tensor parallelism
(`tp_forward`), the GPipe pipeline (`pp`), their 2-D composition (`tp_pp`),
sequence parallelism (`sp`) and tensor-parallel weak-column tuning
(`tp_train`).  Counterpart of ``qeft_tpu/parallel``."""

from qeft_tpu_torch.parallel.mesh import (
    Mesh,
    cache_shardings,
    make_mesh,
    param_shardings,
    shard_params,
    shard_tree,
)
from qeft_tpu_torch.parallel.pp import pp_decode_step, pp_shardings
from qeft_tpu_torch.parallel.sp import llama_decode_step_sp, llama_prefill_sp
