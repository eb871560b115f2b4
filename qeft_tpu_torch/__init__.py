"""PyTorch/CUDA port of qeft_tpu: packed QEFT checkpoints (INT4 codes plus a
weak-column slab) served and fine-tuned on an NVIDIA Hopper GPU through
hand-written CUDA kernels.  The JAX package ``qeft_tpu`` is the reference it
is tested against; this package imports nothing of it."""

__version__ = "0.1.0"
